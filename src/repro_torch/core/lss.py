"""LSS retrieval + sparse-WOL inference (paper Algorithm 2; counterpart of
``repro.core.lss``).

Per query embedding q (from the layer below the WOL)::

    q --augment--> [q,0] --theta--> L bucket ids --tables--> candidate ids
      --bucket-major slab / gather--> sparse logits --dedup+mask--> top-k

Everything is static-shape: the candidate set is ``[B, L*P]`` with -1
padding, and duplicates across tables are masked (not compacted) before
ranking.  On a bucket-major index ``lss_forward`` is one ``lss_topk`` op
(the fused CUDA kernel on the GPU); ``retrieve`` hashes through the
``simhash_codes`` op, and ``sparse_logits_bucketed`` (the unfused path)
scores the hit slabs through the ``bucket_logits`` op.  ``impl=`` pins an
implementation (``ref`` | ``cuda``) and ``dedup=`` the dedup algorithm,
as in the JAX package.  Slab storage (``LSSConfig.slab_dtype``: fp32 |
bf16 | int8) is resolved at :func:`build_index` time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import simhash
from repro_torch.core.tables import LSSTables, build_tables, bucketize_weights
from repro_torch.core.topk import NEG_INF, topk_lowest_index
from repro_torch.kernels import bucket_logits, lss_topk, simhash_codes
from repro_torch.kernels.lss_topk.slabs import (dequantize_slabs,
                                                quantize_slabs,
                                                resolve_slab_dtype)

__all__ = [
    "NEG_INF", "LSSConfig", "LSSIndex", "LSSForward", "build_index",
    "retrieve", "dedup_mask", "sparse_logits_gather", "bucket_slab_inputs",
    "sparse_logits_bucketed", "lss_forward", "lss_predict", "label_recall",
    "precision_at_k", "avg_sample_size",
]


class LSSConfig(NamedTuple):
    k_bits: int = 4
    n_tables: int = 1
    capacity: int = 0          # 0 -> auto: 2 * m / 2^K rounded up to 8
    use_bucket_major: bool = True   # materialise [L, 2^K, P, d] slabs
    slab_dtype: str | None = None   # fp32 | bf16 | int8, None = strategy
    # IUL pair-mining thresholds (inner-product quantiles; see iul.py)
    t1_quantile: float = 0.3
    t2_quantile: float = 0.7
    iul_lr: float = 1e-3
    iul_epochs: int = 8
    iul_batch: int = 256
    iul_inner_steps: int = 8   # gradient steps per mined pair batch

    def resolve_capacity(self, m: int) -> int:
        if self.capacity:
            return self.capacity
        p = -(-2 * m // 2 ** self.k_bits)        # 2x the perfectly-even load
        return max(8, -(-p // 8) * 8)            # round up to a multiple of 8


class LSSIndex(NamedTuple):
    """The frozen serving-time index.  ``w_bucketed`` stores fp32, bf16 or
    int8 slabs; ``w_scale`` is the int8 format's fp32 row-scale table.
    Tables are always built from the fp32 ``w_aug``, so retrieval is the
    same in every format."""

    theta: torch.Tensor              # [d_aug, K*L]
    tables: LSSTables
    w_bucketed: torch.Tensor | None  # [L, 2^K, P, d_aug] or None (gather)
    w_scale: torch.Tensor | None = None  # [L, 2^K, P], int8 only


def build_index(w_aug: torch.Tensor, theta: torch.Tensor, cfg: LSSConfig
                ) -> LSSIndex:
    """Build the tables (and slabs, in the resolved storage format) for the
    hyperplanes ``theta`` on ``w_aug``'s device."""
    cap = cfg.resolve_capacity(w_aug.shape[0])
    tables = build_tables(w_aug, theta, cfg.k_bits, cfg.n_tables, cap)
    if not cfg.use_bucket_major:
        return LSSIndex(theta, tables, None, None)
    wb, w_scale = quantize_slabs(bucketize_weights(w_aug, tables),
                                 resolve_slab_dtype(cfg.slab_dtype))
    return LSSIndex(theta, tables, wb, w_scale)


def retrieve(q_aug: torch.Tensor, index: LSSIndex, impl: str | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Query the L tables.

    Returns ``cand_ids`` int32 ``[B, L*P]`` (-1 = empty slot) and
    ``buckets`` int32 ``[B, L]``.
    """
    t = index.tables
    buckets = simhash_codes(simhash.unit(q_aug), index.theta, t.k_bits,
                            t.n_tables, impl=impl)
    slab_ids = buckets.long() + torch.arange(
        t.n_tables, device=buckets.device) * t.n_buckets         # [B, L]
    cand = t.table_ids.reshape(-1, t.capacity)[slab_ids]         # [B, L, P]
    return cand.reshape(q_aug.shape[0], -1), buckets


def dedup_mask(ids: torch.Tensor) -> torch.Tensor:
    """Bool ``[B, C]``: True for the first occurrence of each id >= 0
    (sort-based)."""
    order = torch.argsort(ids, dim=-1, stable=True)
    sorted_ids = ids.gather(-1, order)
    first = torch.cat([torch.ones_like(sorted_ids[:, :1], dtype=torch.bool),
                       sorted_ids[:, 1:] != sorted_ids[:, :-1]], dim=-1)
    first &= sorted_ids >= 0
    return torch.zeros_like(ids, dtype=torch.bool).scatter_(-1, order, first)


def sparse_logits_gather(q_aug: torch.Tensor, w_aug: torch.Tensor,
                         cand_ids: torch.Tensor) -> torch.Tensor:
    """Gather path: ``[B, d] x [m, d] x [B, C] -> [B, C]``; -1 slots get
    NEG_INF."""
    rows = w_aug[cand_ids.clamp(min=0).long()]            # [B, C, d_aug]
    logits = torch.einsum("bd,bcd->bc", q_aug.float(), rows.float())
    return torch.where(cand_ids >= 0, logits, torch.full_like(logits, NEG_INF))


def bucket_slab_inputs(index: LSSIndex, buckets: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``bucket_logits`` operands of a bucket-major index: its slabs
    viewed as ``[S, P, d]`` (S = L * 2^K) and the int32 ``[B, L]`` slab
    ids ``buckets + l * 2^K``.  fp32 and bf16 slabs go as stored (the op
    widens bf16 in registers); int8 slabs are widened to fp32 here, since
    the op takes no scale table."""
    t = index.tables
    wb = index.w_bucketed
    if wb.dtype == torch.int8:
        wb = dequantize_slabs(wb, index.w_scale)
    w_flat = wb.reshape(t.n_tables * t.n_buckets, t.capacity, wb.shape[-1])
    slab_ids = buckets + torch.arange(
        t.n_tables, dtype=buckets.dtype,
        device=buckets.device)[None, :] * t.n_buckets           # [B, L]
    return w_flat, slab_ids


def sparse_logits_bucketed(q_aug: torch.Tensor, index: LSSIndex,
                           buckets: torch.Tensor, impl: str | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucket-major path: one contiguous ``[P, d]`` slab per (query, table).

    Routes through the registry ``bucket_logits`` op on the operands of
    :func:`bucket_slab_inputs`.  Returns ``(logits, ids)``, both
    ``[B, L*P]``; empty slots (id -1) get NEG_INF.
    """
    t = index.tables
    w_flat, slab_ids = bucket_slab_inputs(index, buckets)
    logits = bucket_logits(q_aug, w_flat, slab_ids, impl=impl)  # [B, L, P]
    ids = t.table_ids.reshape(-1, t.capacity)[slab_ids.long()]  # [B, L, P]
    ids = ids.reshape(q_aug.shape[0], -1)
    logits = logits.reshape(q_aug.shape[0], -1)
    return torch.where(ids >= 0, logits, torch.full_like(logits, NEG_INF)), ids


class LSSForward(NamedTuple):
    """Everything Algorithm 2 produces from one retrieval pass."""

    top_logits: torch.Tensor     # [B, k]
    top_ids: torch.Tensor        # [B, k]   (-1 beyond the candidate count)
    sample_size: torch.Tensor    # [B]      unique neurons scored per query
    cand_ids: torch.Tensor       # [B, C]   retrieved ids, -1 padded


def lss_forward(q: torch.Tensor, index: LSSIndex, w_aug: torch.Tensor | None,
                top_k: int = 5, *, impl: str | None = None,
                dedup: str | None = None) -> LSSForward:
    """Full Algorithm 2 with serving metrics, one retrieval pass.  A
    bucket-major index goes through the fused ``lss_topk`` op; ``w_aug`` is
    needed only for the gather path (``w_bucketed is None``)."""
    q_aug = simhash.augment_queries(q)
    if index.w_bucketed is not None:
        t = index.tables
        out = lss_topk(q_aug, index.theta, t.table_ids, index.w_bucketed,
                       top_k=top_k, impl=impl, dedup=dedup,
                       w_scale=index.w_scale)
        return LSSForward(*out)
    cand_ids, _ = retrieve(q_aug, index, impl=impl)
    logits = sparse_logits_gather(q_aug, w_aug, cand_ids)
    mask = dedup_mask(cand_ids)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    top_logits, pos = topk_lowest_index(logits, top_k)
    top_ids = cand_ids.gather(-1, pos)
    top_ids = torch.where(top_logits > NEG_INF / 2, top_ids,
                          torch.full_like(top_ids, -1))
    return LSSForward(top_logits, top_ids, mask.sum(-1, dtype=torch.int32),
                      cand_ids)


def lss_predict(q: torch.Tensor, index: LSSIndex, w_aug: torch.Tensor | None,
                top_k: int = 5, *, impl: str | None = None,
                dedup: str | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(top-k logits, top-k neuron ids) ``[B, k]`` — see ``lss_forward``."""
    out = lss_forward(q, index, w_aug, top_k, impl=impl, dedup=dedup)
    return out.top_logits, out.top_ids


# ---------------------------------------------------------------- metrics --

def label_recall(cand_ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Paper's label retrieval rate: the fraction of true labels retrieved.
    ``labels``: int32 ``[B, NL]`` padded with -1."""
    hit = (labels[:, :, None] == cand_ids[:, None, :]).any(-1)   # [B, NL]
    valid = labels >= 0
    return (hit & valid).sum() / valid.sum().clamp(min=1)


def precision_at_k(pred_ids: torch.Tensor, labels: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """Standard XMC P@k: mean over samples of |top-k ∩ labels| / k."""
    topk = pred_ids[:, :k]
    hit = (topk[:, :, None] == labels[:, None, :]) & (labels >= 0)[:, None, :]
    return ((hit.any(-1) & (topk >= 0)).sum(-1) / k).mean()


def avg_sample_size(cand_ids: torch.Tensor) -> torch.Tensor:
    """Paper's sample size: mean number of unique neurons scored a query."""
    return dedup_mask(cand_ids).sum(-1).float().mean()
