"""Plain PyTorch version of the ``prefill_attention`` kernel (CPU tensors
take it): ``layers.attention_blockwise``, causal, at the model's chunks."""

from __future__ import annotations

import torch

from repro_torch.models import layers as L


def prefill_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_chunk: int, q_chunk: int | None
                          ) -> torch.Tensor:
    """Causal attention of a prompt: q ``[B, S, N, H]``, k, v ``[B, S, KV,
    H]`` -> ``[B, S, N, H]`` in q's type; the bits of
    ``attention_blockwise(q, k, v, causal=True, kv_chunk, q_chunk)``."""
    return L.attention_blockwise(q, k, v, causal=True, kv_chunk=kv_chunk,
                                 q_chunk=q_chunk)
