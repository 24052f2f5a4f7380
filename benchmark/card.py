"""The card: its name and power limit, and the frozen table of peaks the
roofline shares are read against.

``card_fields`` is mini_parallel_tpu_torch/bench/_common.py's, copied so
that a change to the program cannot move it.
"""

from __future__ import annotations

import json
import os
import subprocess

import torch

PEAKS_FILE = os.path.join(os.path.dirname(__file__), "peaks.json")


def nvidia_smi_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def card_fields(device: torch.device) -> dict:
    """{"name", "power_limit_w", "nvidia_smi"} of the card (``"cpu"`` and
    null on the CPU)."""
    if device.type == "cpu":
        return {"name": "cpu", "power_limit_w": None, "nvidia_smi": None}
    line = nvidia_smi_line()
    name, limit = (part.strip() for part in line.rsplit(",", 1))
    try:
        watts = float(limit.split()[0])
    except (IndexError, ValueError):  # "[N/A]" on a card without a limit
        watts = None
    return {"name": name, "power_limit_w": watts, "nvidia_smi": line}


def peaks(card_name: str) -> dict | None:
    """The frozen peaks of a card by its name, or None for a card the
    table does not hold."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)
    return table.get(card_name)


def int16x2_ops_per_s(card: dict) -> float:
    """The card's highest integer rate at 16-bit width: every SM issues
    ``int32_lanes_per_sm`` 32-bit integer instructions a clock, each on two
    packed 16-bit lanes (DPX ``*_s16x2``), at the boost clock."""
    return (card["sms"] * card["int32_lanes_per_sm"] * 2
            * card["boost_mhz"] * 1e6)
