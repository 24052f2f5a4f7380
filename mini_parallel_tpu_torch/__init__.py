"""mini_parallel_tpu_torch: the PyTorch/CUDA port of mini_parallel_tpu.

The JAX package (``mini_parallel_tpu``) stays the reference; this package
mirrors its layout and module names, imports ``torch`` and numpy and never
``jax``, and carries its own copies of the host modules it needs.

Ported so far: every CLI mode of the JAX package on one device but
``--profile`` and device meshes, with each TPU kernel as a hand-written
CUDA kernel for Hopper (``csrc/``) and the host data plane in C++
(``native/``: the FASTQ decoder, the 2-bit packer, the k-mer store).
Every device is explicit: the engine takes a ``torch.device`` and passes it
down; nothing here picks one behind the caller's back.
"""

__version__ = "0.1.0"
