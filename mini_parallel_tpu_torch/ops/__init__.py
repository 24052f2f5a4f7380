"""Compute ops: encoders, 2-bit packing, scorers and the CUDA kernel
wrapper. Every kernel has its plain PyTorch version in the same package,
used for CPU tensors and held against the kernel on the card."""
