"""Reduced same-family configs for CPU tests and examples (counterpart of
``repro.configs.reduced``).

Same code paths and flags as the full configs (MoE style, GQA ratio,
qk-norm, QKV bias, tied embeddings, AUGRU, ...), tiny dims, fp32.
"""

from __future__ import annotations

import torch

from repro_torch.configs.registry import get_config
from repro_torch.models.gnn import GCNConfig
from repro_torch.models.recsys import Bert4RecConfig, CTRConfig
from repro_torch.models.transformer import TransformerConfig

__all__ = ["reduced_model_cfg"]


def reduced_model_cfg(arch_id: str):
    full = get_config(arch_id).model_cfg
    if isinstance(full, TransformerConfig):
        kw = dict(
            name=full.name + "-reduced", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=max(1, 4 * full.n_kv_heads // full.n_heads),
            head_dim=16, d_ff=128, vocab=512, qkv_bias=full.qkv_bias,
            qk_norm=full.qk_norm, rope_base=full.rope_base,
            tie_embeddings=full.tie_embeddings, moe_style=full.moe_style,
            dtype=torch.float32, kv_chunk=32, q_chunk=64)
        if full.moe_style != "none":
            kw.update(n_experts=4, n_experts_padded=4, moe_top_k=2,
                      moe_d_ff=64, capacity_factor=4.0,
                      shared_expert_ff=96 if full.shared_expert_ff else 0)
        return TransformerConfig(**kw)
    if isinstance(full, GCNConfig):
        return full._replace(d_feat=16, d_hidden=8, n_classes=4)
    if isinstance(full, CTRConfig):
        return full._replace(vocab_per_field=1000,
                             n_fields=min(full.n_fields, 8), embed_dim=8,
                             mlp_dims=(32, 16), seq_len=12, gru_dim=16,
                             n_attn_layers=2, d_attn=8)
    if isinstance(full, Bert4RecConfig):
        return full._replace(n_items=2000, embed_dim=32, seq_len=16)
    raise TypeError(type(full))
