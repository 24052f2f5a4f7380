"""Device meshes and multi-process bring-up: the counterpart of
mini_parallel_tpu/parallel/mesh.py.

A :class:`Mesh` is an array of ``torch.device``s with named axes, as a JAX
mesh is. A device may appear more than once: ``[cpu] * 8`` is the
counterpart of the JAX tests' eight virtual host devices, and
``[cuda:0] * 4`` runs four shards on one card.
"""

from __future__ import annotations

import atexit
import os
import warnings
from datetime import timedelta

import numpy as np
import torch

from mini_parallel_tpu_torch.device import NoAcceleratorError
from mini_parallel_tpu_torch.ops.packed import PackedBatch, pad_rows

DATA_AXIS = "data"  # read-batch (data-parallel) axis
SEQ_AXIS = "seq"  # sequence-position (sequence-parallel) axis


class Mesh:
    """``devices``: an ndarray of ``torch.device``s, one axis per name in
    ``axis_names``. ``shape`` maps each axis name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        axis_names = tuple(axis_names)
        if len(axis_names) != devices.ndim:
            raise ValueError(f"{len(axis_names)} axis names {axis_names} for "
                             f"a {devices.ndim}-D mesh")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate mesh axis names {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str | None = None) -> list[torch.device]:
        """The devices along ``axis`` (default: the first axis), at index 0
        of every other axis: one per shard of a batch split on ``axis``
        and replicated along the others."""
        k = self.axis_names.index(axis or self.axis_names[0])
        index = [0] * self.devices.ndim
        index[k] = slice(None)
        return list(self.devices[tuple(index)])


def make_mesh(shape: tuple[int, ...] | None = None,
              axis_names: tuple[str, ...] | None = None,
              devices: list | None = None) -> Mesh:
    """A mesh over ``devices`` (default: every local CUDA device).

    shape=None: all devices on the data axis. shape=(d, s): a 2-D
    (data, seq) mesh; the seq axis serves the long-pair row bands
    (ops/sw_long.py). Raises NoAcceleratorError when ``devices`` is not
    given and there is no CUDA device, ValueError when the shape does not
    hold the devices.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise NoAcceleratorError(
                "CUDA is not available; pass the mesh's devices explicitly "
                "(e.g. [torch.device('cpu')] * 8) to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if not shape:
        shape = (n,)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    if axis_names is None:
        axis_names = (DATA_AXIS, SEQ_AXIS)[: len(shape)]
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)


def mesh_device(mesh, device: torch.device | str | None
                ) -> torch.device | str | None:
    """The device an engine runs its unsharded work on: ``device``, or on
    a mesh its first device (an explicit ``device`` must be that one)."""
    if mesh is None:
        return device
    first = mesh.devices.flat[0]
    if device is not None:
        d = torch.device(device)
        if d.type != first.type or (d.index is not None
                                    and first.index is not None
                                    and d.index != first.index):
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device {first}")
    return first


def engine_mesh(mesh, device: torch.device) -> Mesh:
    """The mesh an engine shards its batches over: ``mesh``, or without
    one a mesh of the one shard ``device``, so that an engine has one
    batch path for one device and for many."""
    return mesh if mesh is not None else make_mesh((1,), devices=[device])


def pad_to_shards(n: int, num_shards: int, multiple: int = 1) -> int:
    """Round n up so it divides evenly into num_shards * multiple."""
    q = num_shards * multiple
    return -(-n // q) * q


def shard_batch(mesh: Mesh, arrays, data_axis: str | None = None
                ) -> list[tuple[torch.Tensor, ...]]:
    """Split each (B, ...) array into contiguous row blocks, one per shard
    of ``data_axis``, each on its shard's device: -> one tuple of tensors
    per shard, in shard order. B must divide by the shard count."""
    devs = mesh.axis_devices(data_axis)
    n = len(devs)
    shards: list[list[torch.Tensor]] = [[] for _ in devs]
    for a in arrays:
        t = (torch.from_numpy(np.ascontiguousarray(a))
             if isinstance(a, np.ndarray) else a)
        if t.shape[0] % n:
            raise ValueError(f"batch of {t.shape[0]} rows does not split "
                             f"into {n} shards")
        for part, block, dev in zip(shards, torch.split(t, t.shape[0] // n),
                                    devs):
            part.append(block.to(dev, non_blocking=True))
    return [tuple(p) for p in shards]


def put_sharded(pb: PackedBatch, mesh: Mesh, axis: str | None = None
                ) -> list[tuple[torch.Tensor, ...]]:
    """A packed batch's ``device_args`` (ops/packed.py) split over
    ``mesh``: the batch is padded with empty rows (``pad_rows``) to a
    positive multiple of the shard count of ``axis`` (default: the mesh's
    first axis) and cut into contiguous row blocks, one argument tuple per
    shard on its shard's device."""
    n = len(mesh.axis_devices(axis))
    pb = pad_rows(pb, pad_to_shards(max(pb.batch, 1), n))
    return shard_batch(mesh, (pb.packed, pb.exc_col, pb.exc_val, pb.lengths),
                       axis)


# ---------------------------------------------------------------------------
# Multi-process bring-up
# ---------------------------------------------------------------------------


def initialize_distributed() -> bool:
    """Join the process group named by the environment; True in
    distributed mode.

    The JAX CLI's contract: ``JAX_COORDINATOR_ADDRESS`` (host:port of
    process 0) switches distributed mode on; ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID`` name the world size and this process's rank, or,
    where they are unset, torchrun's ``WORLD_SIZE`` and ``RANK``. A rank or
    world size that neither names is an error. The group is gloo: every
    value that crosses processes is a host array (``distributed.py``).
    Each process then selects its card (:func:`local_card`) when CUDA is
    available, and where several processes share the node
    (``LOCAL_WORLD_SIZE`` > 1) caps torch's CPU threads at its share of
    the CPUs (:func:`cpu_share`). The group is destroyed at the
    interpreter's exit. Idempotent.
    """
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coord:
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    nproc = os.environ.get("JAX_NUM_PROCESSES") or os.environ.get("WORLD_SIZE")
    pid = os.environ.get("JAX_PROCESS_ID") or os.environ.get("RANK")
    if not nproc or not pid:
        raise ValueError(
            "JAX_COORDINATOR_ADDRESS is set but the world size or this "
            "process's rank is not: set JAX_NUM_PROCESSES and JAX_PROCESS_ID "
            "(or WORLD_SIZE and RANK)")
    rank, world = int(pid), int(nproc)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside a world of {world}")
    card = (local_card(rank, torch.cuda.device_count())
            if torch.cuda.is_available() else None)
    init = coord if "://" in coord else f"tcp://{coord}"
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank, timeout=timedelta(minutes=30))
    atexit.register(_destroy_group)
    if card is not None:
        torch.cuda.set_device(card)
    share = cpu_share()
    if share is not None and torch.get_num_threads() > share:
        torch.set_num_threads(share)
    return True


def local_card(rank: int, cards: int) -> int:
    """The card of process ``rank`` among the ``cards`` visible:
    ``LOCAL_RANK``, or ``rank % cards`` where it is unset. A ``LOCAL_RANK``
    beyond the visible cards is a ValueError; where the node's processes
    (``LOCAL_WORLD_SIZE``) outnumber its cards, rank 0 warns that they
    share one."""
    local = os.environ.get("LOCAL_RANK")
    card = int(local) if local else rank % cards
    if not 0 <= card < cards:
        raise ValueError(f"LOCAL_RANK {card} names a card beyond the "
                         f"{cards} CUDA card(s) visible")
    procs = int(os.environ.get("LOCAL_WORLD_SIZE") or 1)
    if procs > cards and rank == 0:
        warnings.warn(f"{procs} processes of this node share its {cards} "
                      f"CUDA card(s)", stacklevel=2)
    return card


def cpu_share(cpus: int | None = None) -> int | None:
    """The CPUs each process of this node may take: ``cpus`` (by default
    those this process may run on) over ``LOCAL_WORLD_SIZE``, at least 1;
    None where the node runs one process (``LOCAL_WORLD_SIZE`` unset or
    1)."""
    procs = int(os.environ.get("LOCAL_WORLD_SIZE") or 1)
    if procs <= 1:
        return None
    if cpus is None:
        cpus = len(os.sched_getaffinity(0))
    return max(1, cpus // procs)


def _destroy_group() -> None:
    """End gloo's threads and rank 0's store while the interpreter is
    whole: left to its teardown, they can abort the process (SIGABRT)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 outside a process group)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1
