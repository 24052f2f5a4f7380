"""Accelerator discovery: the counterpart of mini_parallel_tpu/device.py.

The reference made the GPU mandatory (gpu.rs:33-48, main.rs:76-79). So
does the port: :func:`require_cuda` returns the CUDA device or raises,
unless the caller passed an explicit CPU device.
:func:`is_accelerator_available` and :func:`get_devices` are the probes of
gpu.rs:33 and :48 over the CUDA devices. There is no counterpart of the
JAX package's ``enable_compile_cache``: PyTorch runs eagerly and compiles
no program, and each kernel is built once per source hash (``_build.py``).
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass, field

import torch


@dataclass
class DeviceInfo:
    """Mirror of GpuDevice (gpu.rs:18-22): name, platform, index, memory."""

    name: str
    platform: str
    index: int
    memory_gb: float | None = None
    extra: dict = field(default_factory=dict)


def is_accelerator_available() -> bool:
    """Whether a CUDA device is present (is_gpu_available, gpu.rs:33)."""
    return torch.cuda.is_available()


def get_devices() -> list[DeviceInfo]:
    """Every CUDA device, with its name and memory (get_gpu_devices,
    gpu.rs:48); empty without CUDA."""
    if not torch.cuda.is_available():
        return []
    return [DeviceInfo(name=torch.cuda.get_device_name(i), platform="gpu",
                       index=i,
                       memory_gb=torch.cuda.get_device_properties(i)
                       .total_memory / 2**30)
            for i in range(torch.cuda.device_count())]


class NoAcceleratorError(RuntimeError):
    """CUDA was required and is not available."""


def require_cuda(device: torch.device | str | None = None) -> torch.device:
    """The device to run on: ``device`` if given, else ``cuda``.

    An explicit CPU device is honoured (the ``--allow-cpu`` path and the
    CPU tests). Anything else needs CUDA and raises without it.
    """
    if device is not None:
        device = torch.device(device)
        if device.type == "cpu":
            return device
    if not torch.cuda.is_available():
        raise NoAcceleratorError(
            "CUDA is not available; pass an explicit CPU device "
            "(--allow-cpu) to run on the CPU")
    return device if device is not None else torch.device("cuda")


def nvidia_smi_line() -> str:
    """The card's name and power limit, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (one line per card, first card only)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def device_info() -> dict:
    """Card name, card count and power limit of CUDA device 0."""
    line = nvidia_smi_line()
    return {
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "power_limit": line.rsplit(",", 1)[-1].strip(),
        "nvidia_smi": line,
    }
