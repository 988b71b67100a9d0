"""Symmetric per-row int8 quantization (counterpart of
``repro.optim.compression.quantize_int8_rows`` / ``dequantize_int8_rows``).

The quantized LSS slab storage stores one fp32 scale per neuron row; the
fused ``lss_topk`` kernel dequantizes on the fly with the same elementwise
op as :func:`dequantize_int8_rows`.  The gradient-compression half of the
JAX module waits for the training slices.
"""

from __future__ import annotations

import torch

__all__ = ["quantize_int8_rows", "dequantize_int8_rows"]


def quantize_int8_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 along the LAST axis: one scale per leading row.

    ``[..., d] -> (q int8 [..., d], scale f32 [...])`` with
    ``scale = max|row| / 127 + 1e-12`` (the eps keeps all-zero rows —
    empty LSS slots — dequantizing to exactly 0).  Rounds half to even,
    as ``jnp.round`` does.
    """
    rows = x.float()
    scale = rows.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(rows / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8_rows(q: torch.Tensor, scale: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q [..., d] * scale [..., None] -> [..., d]``."""
    return (q.float() * scale[..., None]).to(dtype)
