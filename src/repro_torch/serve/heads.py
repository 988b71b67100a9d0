"""Pluggable WOL head protocol (counterpart of ``repro.serve.heads``).

A *head* is a function ``q [B, d] -> HeadOutput`` ranking the wide
output layer for a batch of query embeddings:

  * ``full`` — exact ``q @ W.T + b`` (``torch.matmul``; TF32 is off on
    the card, ``device.resolve_device``) then top-k with the lowest index
    first on ties, as ``jax.lax.top_k``.
  * ``lss``  — Algorithm 2 over a fitted :class:`LSSIndex`: one
    ``lss_forward``, i.e. the fused ``lss_topk`` kernel on the card
    (single retrieval pass; sample size comes from the same pass).
  * ``lss-sharded`` — the vocab-sharded index from ``core.sharded``:
    shard-local retrieve + top-k, O(TP*k) all-gather, global top-k.  Its
    head is a :class:`SplitHead`: the ``local`` part (the shards this
    rank holds) and the ``merge`` (collectives and the global top-k), so
    a serving step captures the first and runs the second after the
    replay (``serve.step``).

All heads return the same :class:`HeadOutput`, so the engine's batcher,
metrics and the decode loop are head-agnostic.

The JAX package's multi-process head also carries ``global_operands``
and ``with_operands``: ``jit`` cannot close over arrays that span
devices of other processes, so the stacks travel as explicit arguments.
A rank here holds its own shards as ordinary tensors and a step closes
over them, so neither exists (nor ``multihost.assemble_global_stack``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.lss import LSSConfig, LSSIndex, lss_forward
from repro_torch.core.sharded import (build_local_index, local_part,
                                      multihost_merge, sharded_merge)
from repro_torch.core.tables import LSSTables
from repro_torch.core.topk import NEG_INF, topk_lowest_index

__all__ = ["HeadOutput", "HEAD_KINDS", "SplitHead", "make_full_head",
           "make_lss_head", "make_sharded_lss_head",
           "make_multihost_lss_head", "shard_index"]

HEAD_KINDS = ("full", "lss", "lss-sharded")


class HeadOutput(NamedTuple):
    """What every head returns for a query batch."""

    logits: torch.Tensor               # [B, k] top-k scores
    ids: torch.Tensor                  # [B, k] int32 neuron ids (-1 = none)
    sample_size: torch.Tensor          # [B]    int32 neurons scored
    cand_ids: torch.Tensor | None      # [B, C] retrieved set (None: full)


def make_full_head(w: torch.Tensor, b: torch.Tensor, top_k: int
                   ) -> Callable[[torch.Tensor], HeadOutput]:
    """Exact WOL: every neuron is scored (sample size == m)."""
    m = w.shape[0]
    w_t, b = w.float().T, b.float()

    def head(q: torch.Tensor) -> HeadOutput:
        top, ids = topk_lowest_index(q.float() @ w_t + b, top_k)
        sample = torch.full((q.shape[0],), m, dtype=torch.int32,
                            device=q.device)
        return HeadOutput(top, ids.int(), sample, None)

    return head


def make_lss_head(index: LSSIndex, w_aug: torch.Tensor | None, top_k: int
                  ) -> Callable[[torch.Tensor], HeadOutput]:
    """Algorithm 2 over one fitted index, with the implementation the
    tensors' device selects."""

    def head(q: torch.Tensor) -> HeadOutput:
        out = lss_forward(q.float(), index, w_aug, top_k)
        return HeadOutput(out.top_logits, out.top_ids, out.sample_size,
                          out.cand_ids)

    return head


class SplitHead:
    """A head in two parts: ``local(q)`` (this rank's shards, no
    collective: it may be captured in a CUDA graph) and ``merge(part)``
    (the collectives and the global top-k, run eagerly after it).
    Calling the head runs both."""

    def __init__(self, local: Callable, merge: Callable[..., HeadOutput]):
        self.local = local
        self.merge = merge

    def __call__(self, q: torch.Tensor) -> HeadOutput:
        return self.merge(self.local(q))


def _mask_index_tail(index: LSSIndex, n_valid: int) -> LSSIndex:
    """Remove local row ids >= ``n_valid`` (vocab padding) from a shard's
    tables: their slots become -1 and their slab rows zero, so padded
    neurons are simply never retrieved."""
    t = index.tables
    ids = torch.where(t.table_ids < n_valid, t.table_ids,
                      torch.full_like(t.table_ids, -1))
    tables = LSSTables(ids, t.n_dropped, t.k_bits, t.n_tables, t.capacity)
    wb = index.w_bucketed
    if wb is not None:
        # an int8 zero code (and a zeroed scale) dequantizes to exactly 0,
        # as fp32/bf16 zeros do
        wb = torch.where((ids >= 0)[..., None], wb, torch.zeros_like(wb))
    ws = index.w_scale
    if ws is not None:
        # pad rows carry the NEG_INF sentinel bias, so their row scale is
        # a huge garbage value: a masked slot is all-zero in both leaves
        ws = torch.where(ids >= 0, ws, torch.zeros_like(ws))
    return LSSIndex(index.theta, tables, wb, ws)


def shard_index(w_aug: torch.Tensor, theta: torch.Tensor, cfg: LSSConfig,
                n_shards: int, *, shard_range: tuple[int, int] | None = None,
                m_total: int | None = None
                ) -> tuple[list[LSSIndex], torch.Tensor | None, int]:
    """Split the WOL rows into ``n_shards`` contiguous vocab shards and
    build one local index per shard.

    When ``m % n_shards != 0`` the rows are padded up to the next multiple
    and the padded ids are masked out of the final shard's tables
    (:func:`_mask_index_tail`), so a padded neuron can never be retrieved
    and arbitrary vocab sizes shard without changing any real query's
    result.  The pad rows carry a NEG_INF bias column purely as a
    sentinel for humans inspecting ``w_stack`` dumps — queries are
    augmented with 0, so a bias never reaches a logit; the table masking
    is what excludes padding, not the sentinel.

    ``shard_range=(lo, hi)`` builds ONLY shards [lo, hi): ``w_aug`` then
    holds just the global rows those shards cover —
    ``[lo * m_local, min(hi * m_local, m_total))`` — and ``m_total``
    (the full vocab size) is required for the pad/mask math.  This is
    the multi-process build path: each rank constructs the shards it
    holds from its own row slice and never the full ``[m, d]`` weight.
    The per-shard indexes (the int8 ``w_scale`` included) are
    bit-identical to the same shards of a full-range build.

    Returns (the ``hi - lo`` per-shard indexes, ``w_stack`` ``[hi - lo,
    m_local, d]`` on a gather-path config or None, m_local).  The JAX
    package stacks the indexes' leaves instead (``convert`` turns such a
    stack into this list).
    """
    if shard_range is None:
        if m_total is not None and m_total != w_aug.shape[0]:
            raise ValueError(f"m_total={m_total} disagrees with "
                             f"w_aug rows {w_aug.shape[0]}")
        m_total = w_aug.shape[0]
        shard_range = (0, n_shards)
    elif m_total is None:
        raise ValueError("shard_range requires m_total (the FULL vocab "
                         "size; w_aug holds only the range's rows)")
    lo, hi = shard_range
    if not 0 <= lo < hi <= n_shards:
        raise ValueError(f"shard_range {shard_range} outside "
                         f"[0, {n_shards})")
    m = m_total
    m_local = -(-m // n_shards)
    row0 = lo * m_local
    n_rows_need = max(min(hi * m_local, m) - row0, 0)
    if w_aug.shape[0] != n_rows_need:
        raise ValueError(
            f"shard_range {shard_range} of m={m} needs rows "
            f"[{row0}, {row0 + n_rows_need}) = {n_rows_need} rows, "
            f"got {w_aug.shape[0]}")
    if hi * m_local > row0 + n_rows_need:         # padded vocab tail
        pad = w_aug.new_zeros((hi * m_local - row0 - n_rows_need,
                               w_aug.shape[-1]))
        pad[:, -1] = NEG_INF                      # sentinel bias column
        w_aug = torch.cat([w_aug, pad])
    locals_ = []
    for i in range(lo, hi):
        idx = build_local_index(
            w_aug[(i - lo) * m_local:(i - lo + 1) * m_local], theta, cfg)
        n_valid = min(max(m - i * m_local, 0), m_local)
        if n_valid < m_local:
            idx = _mask_index_tail(idx, n_valid)
        locals_.append(idx)
    w_stack = None
    if not cfg.use_bucket_major:
        w_stack = w_aug.reshape(hi - lo, m_local, w_aug.shape[-1])
    return locals_, w_stack, m_local


def _split_head(merge, index_stack, w_stack, mesh, m_local: int,
                top_k: int) -> SplitHead:
    shard0 = mesh.shard_range()[0]
    if len(index_stack) != mesh.shards_per_rank:
        raise ValueError(f"{len(index_stack)} local shards for a mesh of "
                         f"{mesh.shards_per_rank} a rank")

    def local(q: torch.Tensor):
        return local_part(q.float(), index_stack, w_stack, k=top_k,
                          shard0=shard0, m_local=m_local)

    def merged(part) -> HeadOutput:
        logits, ids, sample = merge(part, top_k, mesh)
        return HeadOutput(logits, ids, sample, None)

    return SplitHead(local, merged)


def make_sharded_lss_head(index_stack: list[LSSIndex], w_stack, mesh,
                          m_local: int, top_k: int) -> SplitHead:
    """Vocab-sharded Algorithm 2 over ``mesh`` (a
    ``distributed.ServingMesh``; ``index_stack`` holds the shards of
    ``mesh.shard_range()``): the flat merge, the sample size summed
    across shards.

    ``cand_ids`` is None: the retrieved sets live shard-local and only the
    O(TP*k) winners cross the interconnect — recall metrics fall back to
    the top-k set.  The JAX head's config and axis names have no
    counterpart: the mesh's groups are what the merge uses.
    """
    return _split_head(sharded_merge, index_stack, w_stack, mesh, m_local,
                       top_k)


def make_multihost_lss_head(index_stack: list[LSSIndex], w_stack, mesh,
                            m_local: int, top_k: int) -> SplitHead:
    """:func:`make_sharded_lss_head` over a multi-process (host, model)
    mesh: per-shard retrieve, the hierarchical O(hosts*k) cross-host merge
    (``core.sharded.multihost_merge``), the sample size summed over the
    whole fleet.  Build ``index_stack`` with ``shard_index(...,
    shard_range=mesh.shard_range(), m_total=m)``."""
    return _split_head(multihost_merge, index_stack, w_stack, mesh,
                       m_local, top_k)
