"""Plain PyTorch version of the ``bucket_logits`` kernel (the ``lss_topk``
plain version composes it too)."""

from __future__ import annotations

import torch


def bucket_logits_ref(q: torch.Tensor, w_slabs: torch.Tensor,
                      slab_ids: torch.Tensor) -> torch.Tensor:
    """Per-query contiguous-slab logits.

    ``q [B, d]``, ``w_slabs [S, P, d]`` (S = L * 2^K), int32
    ``slab_ids [B, L]`` -> fp32 ``[B, L, P]`` logits ``q . w`` for every
    slot of the hit slabs (zero rows in empty slots give 0; masking by id
    is the caller's).
    """
    slabs = w_slabs[slab_ids.long()]                  # [B, L, P, d]
    return torch.einsum("bd,blpd->blp", q.float(), slabs.float())
