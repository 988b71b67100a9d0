"""Symmetric int8 quantization (counterpart of
``repro.optim.compression``): per row and blockwise.

The quantized LSS slab storage stores one fp32 scale per neuron row; the
fused ``lss_topk`` kernel dequantizes on the fly with the same elementwise
op as :func:`dequantize_int8_rows`.  :func:`quantize_int8` is the
blockwise form the JAX package's gradient compression uses: the tensor
flattened, zero-padded to whole blocks of 256, one scale a block.
``compressed_psum`` and ``init_error_state`` wait for the multi-GPU slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["quantize_int8", "dequantize_int8", "quantize_int8_rows",
           "dequantize_int8_rows"]

_BLOCK = 256


def _blocked(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    return F.pad(flat, (0, (-flat.numel()) % _BLOCK)).reshape(-1, _BLOCK)


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


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8: ``(q int8 [nb, 256], scale f32 [nb])``."""
    return quantize_int8_rows(_blocked(x))


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape: tuple,
                    dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` for a tensor of ``shape``: the
    padding is cut off."""
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape).to(dtype)
