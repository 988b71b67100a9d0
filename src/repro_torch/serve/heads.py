"""Pluggable WOL head protocol (counterpart of ``repro.serve.heads``).

A *head* is a function ``q [B, d] -> HeadOutput`` ranking the wide
output layer for a batch of query embeddings:

  * ``full`` — exact ``q @ W.T + b`` (``torch.matmul``; TF32 is off on
    the card, ``device.resolve_device``) then top-k with the lowest index
    first on ties, as ``jax.lax.top_k``.
  * ``lss``  — Algorithm 2 over a fitted :class:`LSSIndex`: one
    ``lss_forward``, i.e. the fused ``lss_topk`` kernel on the card
    (single retrieval pass; sample size comes from the same pass).

The vocab-sharded head (``lss-sharded``, with ``shard_index``) comes with
multi-GPU sharding.  Both heads return the same :class:`HeadOutput`, so
the engine's batcher and metrics are head-agnostic.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.lss import LSSIndex, lss_forward
from repro_torch.core.topk import topk_lowest_index

__all__ = ["HeadOutput", "HEAD_KINDS", "make_full_head", "make_lss_head"]

HEAD_KINDS = ("full", "lss")


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
