"""Device meshes, sharded steps and multi-process runs: the counterpart of
mini_parallel_tpu/parallel/.

The JAX package's mesh is single-controller: one process drives every
local chip, ``shard_map`` runs a body once per device, and ``psum`` /
``pmax`` / ``ppermute`` cross devices. The port keeps that model inside one
process: a :class:`~mini_parallel_tpu_torch.parallel.mesh.Mesh` is an array
of ``torch.device``s, a sharded step calls its body once per shard on that
shard's device with that shard's rows (the kernels are asynchronous, so
shards on different cards overlap), and the per-shard results merge on the
mesh's first device in shard order (``collectives``). Across processes
(``distributed``), totals merge with one ``torch.distributed`` all-gather
over gloo: every value the JAX package sends between processes is a host
array.
"""
