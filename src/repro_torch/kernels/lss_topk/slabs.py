"""Slab storage formats for the fused ``lss_topk`` path (counterpart of
``repro.kernels.lss_topk.slabs``).

``fp32`` (4 B/element), ``bf16`` (2 B, a plain cast) or ``int8`` (1 B +
one fp32 scale per neuron row, ``optim.compression.quantize_int8_rows``),
selected by the registry strategy ``lss_topk.slab_dtype`` (explicit >
process override > ``$REPRO_LSS_SLAB_DTYPE`` > auto = fp32) and
resolved once, at ``core.lss.build_index`` time.  The plain version widens
the whole slab tensor before its product; the CUDA kernel widens each row
in registers with the same elementwise op.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import registry
from repro_torch.optim.compression import (dequantize_int8_rows,
                                           quantize_int8_rows)

__all__ = [
    "SLAB_DTYPE_CHOICES", "SLAB_DTYPE_ENV_VAR", "slab_dtype_strategy",
    "resolve_slab_dtype", "slab_dtype_of", "slab_itemsize",
    "quantize_slabs", "dequantize_slabs", "lss_topk_slab_dma_bytes",
]

SLAB_DTYPE_CHOICES = ("fp32", "bf16", "int8")
SLAB_DTYPE_ENV_VAR = "REPRO_LSS_SLAB_DTYPE"

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
_NAMES = {v: k for k, v in _DTYPES.items()}
_ITEMSIZE = {"fp32": 4, "bf16": 2, "int8": 1}


def _auto_slab_dtype(**_ctx) -> str:
    """fp32: compressed storage is an opt-in accuracy trade."""
    return "fp32"


slab_dtype_strategy = registry.kernel_strategy(
    "lss_topk.slab_dtype", SLAB_DTYPE_CHOICES, env_var=SLAB_DTYPE_ENV_VAR,
    auto=_auto_slab_dtype)


def resolve_slab_dtype(requested: str | None = None, **ctx) -> str:
    """Resolve the slab storage format (logged as
    ``("lss_topk.slab_dtype", choice)``)."""
    return slab_dtype_strategy.resolve(requested, **ctx)


def slab_dtype_of(w_bucketed: torch.Tensor) -> str:
    """The strategy name for a slab tensor's dtype (fp32|bf16|int8)."""
    name = _NAMES.get(w_bucketed.dtype)
    if name is None:
        raise ValueError(
            f"slab dtype {w_bucketed.dtype} is not one of the "
            f"lss_topk.slab_dtype storage formats {SLAB_DTYPE_CHOICES}")
    return name


def slab_itemsize(slab_dtype: str) -> int:
    """Bytes per slab element for a storage format name."""
    return _ITEMSIZE[slab_dtype]


def quantize_slabs(w_bucketed: torch.Tensor, slab_dtype: str
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """fp32 ``[L, 2^K, P, d]`` slabs -> ``(slabs, scales)``; ``scales`` is
    the fp32 ``[L, 2^K, P]`` table for int8 and None otherwise.  Empty
    slots are zero rows and stay exactly 0 in every format."""
    if slab_dtype in ("fp32", "bf16"):
        return w_bucketed.to(_DTYPES[slab_dtype]), None
    if slab_dtype == "int8":
        return quantize_int8_rows(w_bucketed)
    raise ValueError(f"slab_dtype must be one of {SLAB_DTYPE_CHOICES}, "
                     f"got {slab_dtype!r}")


def dequantize_slabs(w_bucketed: torch.Tensor,
                     w_scale: torch.Tensor | None) -> torch.Tensor:
    """Widen stored slabs back to fp32."""
    if slab_dtype_of(w_bucketed) == "int8":
        if w_scale is None:
            raise ValueError("int8 slabs need their scale table")
        return dequantize_int8_rows(w_bucketed, w_scale)
    return w_bucketed.float()


def lss_topk_slab_dma_bytes(n_tables: int, cap: int, d: int,
                            slab_dtype: str = "fp32") -> int:
    """Slab bytes one query reads when every slot is read: ``L`` slabs of
    ``[P, d]`` weights + ``[P]`` int32 ids, + a ``[P]`` fp32 scale row per
    slab for int8 (420,160 B at Delicious-200K in fp32)."""
    per_slab = cap * d * slab_itemsize(slab_dtype) + cap * 4
    if slab_dtype == "int8":
        per_slab += cap * 4
    return n_tables * per_slab
