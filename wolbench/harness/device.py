"""The card: whether it is there, what it is, its power limit, its
memory peak."""

from __future__ import annotations

import subprocess

import torch

__all__ = ["require_cards", "device_line", "power_limit"]


def require_cards(n: int) -> str | None:
    """None when ``n`` CUDA cards are visible, else why not."""
    if not torch.cuda.is_available():
        return "no CUDA card is available"
    if torch.cuda.device_count() < n:
        return (f"the cell needs {n} CUDA cards, "
                f"{torch.cuda.device_count()} are visible")
    return None


def power_limit() -> str:
    """``name, power.limit`` as ``nvidia-smi`` reads them ('' if it
    cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def device_line(device: torch.device, count: int, peak_bytes: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "memory_peak_bytes": peak_bytes}
