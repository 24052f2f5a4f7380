"""mini_parallel_tpu_torch: the PyTorch/CUDA port of mini_parallel_tpu.

The JAX package (``mini_parallel_tpu``) stays the reference; this package
mirrors its layout and module names, imports ``torch`` and numpy and never
``jax``, and carries its own copies of the host modules it needs.

Ported: every CLI mode of the JAX package, with ``--profile`` and the
system monitors; device meshes (``MPT_MESH_SHAPE``: the sharded engines
and the long-pair row bands) and multi-process ``--full-wgs`` over
``torch.distributed`` (``parallel/``); each TPU kernel as a hand-written
CUDA kernel for Hopper (``csrc/``); the host data plane in C++
(``native/``: the FASTQ decoder, the 2-bit packer, the k-mer store); and
the JAX package's tools (``tools/``).
Every device is explicit: the engine takes a ``torch.device`` and passes it
down; nothing here picks one behind the caller's back.
"""

__version__ = "0.1.0"
