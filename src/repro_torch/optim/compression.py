"""Symmetric int8 quantization (counterpart of
``repro.optim.compression``): per row and blockwise.

The quantized LSS slab storage stores one fp32 scale per neuron row; the
fused ``lss_topk`` kernel dequantizes on the fly with the same elementwise
op as :func:`dequantize_int8_rows`.  :func:`quantize_int8` is the
blockwise form the JAX package's gradient compression uses: the tensor
flattened, zero-padded to whole blocks of 256, one scale a block.

:func:`compressed_psum` is the JAX package's error-feedback int8 mean
all-reduce over a data-parallel axis (the slow links between pods): each
rank quantizes its gradient plus the error it carried, all-gathers the
int8 payload and the block scales over a process group (1 byte an
element and 4 bytes a block of 256 on the wire, against 4 bytes an
element in fp32), dequantizes every rank's part, sums them in rank order
and divides by the ranks; what its own quantization lost is the next
step's error.  It takes each rank's own gradients, as the JAX function
sees its block inside ``shard_map``.
"""

from __future__ import annotations

import math

from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["quantize_int8", "dequantize_int8", "quantize_int8_rows",
           "dequantize_int8_rows", "compressed_psum", "init_error_state"]

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


def init_error_state(params: Any) -> Any:
    """Zero fp32 error feedback, a tree like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``[n, *x.shape]``: every rank's ``x`` in group rank order."""
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.reshape((n,) + tuple(x.shape))


def compressed_psum(grads: Any, err: Any, group=None) -> tuple[Any, Any]:
    """Error-feedback int8 mean-all-reduce over the ranks of ``group``
    (the default group if None).  ``grads`` and ``err`` are trees of this
    rank's tensors (``err`` fp32, from :func:`init_error_state`).  Returns
    ``(global grads, new error state)``: the mean of every rank's
    dequantized gradient-plus-error, in each gradient's dtype, and this
    rank's quantization residual."""
    n = dist.get_world_size(group)

    def one(g, e):
        corrected = g.float() + e
        q, scale = quantize_int8(corrected)
        new_err = corrected - dequantize_int8(q, scale, g.shape,
                                              torch.float32)
        q_all = _all_gather(q, group)                    # [n, nb, 256] i8
        s_all = _all_gather(scale, group)                # [n, nb]
        deq = q_all[0].float() * s_all[0][:, None]
        for r in range(1, n):                            # rank order
            deq = deq + q_all[r].float() * s_all[r][:, None]
        flat = deq.reshape(-1)[:corrected.numel()].reshape(g.shape)
        return (flat / n).to(g.dtype), new_err

    flat_g, treedef = tree_flatten(grads)
    out = [one(g, e) for g, e in zip(flat_g, tree_flatten(err)[0])]
    return (tree_unflatten(treedef, [o[0] for o in out]),
            tree_unflatten(treedef, [o[1] for o in out]))
