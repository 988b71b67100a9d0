"""Plain PyTorch version of the fused ``lss_topk`` kernel, written as the
JAX oracle is (``repro.kernels.lss_topk.ref``): the ``simhash_codes`` and
``bucket_logits`` plain versions composed with the dedup + top-k
epilogue.  Quantized slabs are widened whole up front; the kernel widens
each row with the same elementwise op.
"""

from __future__ import annotations

import torch

from repro_torch.core.simhash import unit
from repro_torch.core.topk import NEG_INF, topk_lowest_index
from repro_torch.kernels.bucket_logits.ref import bucket_logits_ref
from repro_torch.kernels.lss_topk.dedup import (dedup_mask_bitonic,
                                                dedup_mask_quadratic,
                                                resolve_dedup)
from repro_torch.kernels.lss_topk.slabs import dequantize_slabs
from repro_torch.kernels.simhash_codes.ref import simhash_codes_ref


def lss_topk_ref(q_aug: torch.Tensor, theta: torch.Tensor,
                 table_ids: torch.Tensor, w_bucketed: torch.Tensor, *,
                 top_k: int, dedup: str | None = None,
                 w_scale: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Retrieve -> slab logits -> dedup mask -> top-k.

    Args:
      q_aug:      ``[B, d_aug]`` bias-augmented queries.
      theta:      ``[d_aug, K*L]`` hyperplanes.
      table_ids:  int32 ``[L, 2^K, P]`` bucket-major ids, -1 padded.
      w_bucketed: ``[L, 2^K, P, d_aug]`` slabs (fp32 | bf16 | int8).
      dedup:      ``quadratic`` | ``bitonic`` | None (auto on C = L*P).
      w_scale:    fp32 ``[L, 2^K, P]`` row scales (int8 only).

    Returns:
      (top_logits [B,k] f32, top_ids [B,k] i32, sample_size [B] i32,
       cand_ids [B, L*P] i32).
    """
    n_tables, n_buckets, cap = table_ids.shape
    k_bits = n_buckets.bit_length() - 1
    bsz = q_aug.shape[0]
    w_bucketed = dequantize_slabs(w_bucketed, w_scale)

    buckets = simhash_codes_ref(unit(q_aug), theta, k_bits, n_tables)
    slab_ids = buckets + torch.arange(
        n_tables, dtype=buckets.dtype, device=buckets.device) * n_buckets

    cand = table_ids.reshape(-1, cap)[slab_ids.long()].reshape(bsz, -1)
    w_flat = w_bucketed.reshape(-1, cap, w_bucketed.shape[-1])
    logits = bucket_logits_ref(q_aug, w_flat, slab_ids).reshape(bsz, -1)

    # an explicit dedup= arrives pre-resolved (and logged) from the op
    choice = (dedup if dedup is not None
              else resolve_dedup(None, n_candidates=cand.shape[-1]))
    if choice not in ("quadratic", "bitonic"):
        raise ValueError(f"dedup must be quadratic|bitonic, got {choice!r}")
    mask = (dedup_mask_quadratic(cand) if choice == "quadratic"
            else dedup_mask_bitonic(cand))
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    top_logits, pos = topk_lowest_index(logits, top_k)
    top_ids = cand.gather(-1, pos)
    top_ids = torch.where(top_logits > NEG_INF / 2, top_ids,
                          torch.full_like(top_ids, -1))
    return top_logits, top_ids, mask.sum(-1, dtype=torch.int32), cand
