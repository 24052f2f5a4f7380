"""mini_parallel_tpu_torch: the PyTorch/CUDA port of mini_parallel_tpu.

The JAX package (``mini_parallel_tpu``) stays the reference; this package
mirrors its layout and module names, imports ``torch`` and numpy and never
``jax``, and carries its own copies of the host modules it needs.

Ported so far: the ``--full-wgs`` self-alignment path in ``kadane`` and
``sw`` mode, with the batched Smith-Waterman score as a hand-written CUDA
kernel for Hopper (``csrc/sw_score.cu``, bound in ``ops/sw_cuda.py``).
Every device is explicit: the engine takes a ``torch.device`` and passes it
down; nothing here picks one behind the caller's back.
"""

__version__ = "0.1.0"
