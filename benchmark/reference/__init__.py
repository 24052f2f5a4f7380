"""Plain references that decide ``correct``: NumPy and plain PyTorch
only. They import nothing of the program, take only the generated inputs,
and work out again whatever the program derives from them."""
