"""qwen2-0.5b [dense] 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 — GQA, QKV bias, tied embeddings [arXiv:2407.10671; hf]
(counterpart of ``repro.configs.qwen2_0_5b``)."""

import torch

from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.core.lss import LSSConfig
from repro_torch.models.transformer import TransformerConfig

__all__ = ["CONFIG"]

CONFIG = ArchSpec(
    arch_id="qwen2-0.5b",
    family="lm",
    model_cfg=TransformerConfig(
        name="qwen2-0.5b", n_layers=24, d_model=896, n_heads=14,
        n_kv_heads=2, head_dim=64, d_ff=4864, vocab=151936,
        qkv_bias=True, qk_norm=False, rope_base=1e6,
        tie_embeddings=True, dtype=torch.bfloat16),
    shapes=lm_shapes(),
    lss=LSSConfig(k_bits=10, n_tables=1),
    notes="LSS serves the 151936-wide LM head at decode.",
)
