"""System/device introspection: the counterpart of
mini_parallel_tpu/utils/system_info.py.

Mirrors the reference's ``SystemInfo`` intent
(`smith_waterman/src/system_info.rs:16-45`): device name and memory for
banners, the memory budget, and benchmark metadata. Device facts come from
``torch.cuda`` for the device the engine runs on; host RAM from
/proc/meminfo (system_info.rs:197-233).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import torch

HBM_BUDGET_FRACTION = 0.8  # 80%-of-memory budget, system_info.rs:236-238


@dataclass
class SystemInfo:
    device_kind: str = "unknown"
    device_count: int = 0
    platform: str = "none"
    hbm_bytes_limit: int | None = None
    cpu_cores: int = 0
    total_ram_gb: float = 0.0

    def available_device_memory_bytes(self) -> int | None:
        """80% of the card's memory (system_info.rs:236-243); None on the
        CPU, where the budget check is a no-op."""
        if self.hbm_bytes_limit is None:
            return None
        return int(self.hbm_bytes_limit * HBM_BUDGET_FRACTION)

    def banner(self) -> str:
        hbm = (
            f"{self.hbm_bytes_limit / 2**30:.1f} GB HBM"
            if self.hbm_bytes_limit
            else "HBM unknown"
        )
        return (
            f"Device: {self.device_kind} x{self.device_count} ({self.platform}, {hbm}) | "
            f"Host: {self.cpu_cores} cores, {self.total_ram_gb:.0f} GB RAM"
        )


def _host_ram_gb() -> float:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) / (1024 * 1024)
    except OSError:
        pass
    return 0.0


@functools.lru_cache(maxsize=None)
def get_system_info(device: torch.device) -> SystemInfo:
    """Facts about ``device`` and the host, computed once per device."""
    info = SystemInfo(
        cpu_cores=os.cpu_count() or 0,
        total_ram_gb=_host_ram_gb(),
        platform=device.type,
    )
    if device.type == "cuda":
        info.device_kind = torch.cuda.get_device_name(device)
        info.device_count = torch.cuda.device_count()
        info.hbm_bytes_limit = torch.cuda.mem_get_info(device)[1]
    else:
        info.device_kind = "cpu"
        info.device_count = 1
    return info
