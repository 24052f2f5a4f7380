"""Accelerator discovery: the counterpart of mini_parallel_tpu/device.py.

The reference made the GPU mandatory (gpu.rs:33-48, main.rs:76-79). So
does the port: :func:`require_cuda` returns the CUDA device or raises,
unless the caller passed an explicit CPU device. There is no compile-cache
helper: PyTorch runs eagerly, and the one kernel is built once per source
hash (``_build.py``).
"""

from __future__ import annotations

import subprocess

import torch


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
