"""Reduced same-family configs for CPU tests and examples (counterpart of
the transformer branch of ``repro.configs.reduced``).

Same code paths and flags as the full configs (GQA ratio, qk-norm, QKV
bias, tied embeddings), tiny dims, fp32.  The other families (MoE,
GNN, recsys) come with the rest of the model zoo (ROADMAP Queue 1 item
8).
"""

from __future__ import annotations

import torch

from repro_torch.configs import qwen2_0_5b, qwen3_4b
from repro_torch.models.transformer import TransformerConfig

__all__ = ["ARCHS", "reduced_model_cfg"]

#: the full configs the port holds, by the JAX package's arch ids
ARCHS = {"qwen2-0.5b": qwen2_0_5b.CONFIG, "qwen3-4b": qwen3_4b.CONFIG}


def reduced_model_cfg(arch_id: str) -> TransformerConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; the port holds "
                       f"{sorted(ARCHS)} (the rest of the model zoo is "
                       f"ROADMAP Queue 1 item 8)")
    full = ARCHS[arch_id]
    return TransformerConfig(
        name=full.name + "-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, 4 * full.n_kv_heads // full.n_heads),
        head_dim=16, d_ff=128, vocab=512, qkv_bias=full.qkv_bias,
        qk_norm=full.qk_norm, rope_base=full.rope_base,
        tie_embeddings=full.tie_embeddings, moe_style=full.moe_style,
        dtype=torch.float32, kv_chunk=32, q_chunk=64)
