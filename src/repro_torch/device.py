"""Device resolution: entry points run on the GPU unless asked for the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent.

    The card path starts here, so this is where fp32 matrix products and
    convolutions are pinned to full fp32: TF32 keeps ~3 decimal digits,
    which would break the parity tolerances against the JAX reference.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
