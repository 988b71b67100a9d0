"""qwen2-7b [dense] 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — GQA, QKV bias [arXiv:2407.10671; hf] (counterpart of
``repro.configs.qwen2_7b``)."""

import torch

from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.core.lss import LSSConfig
from repro_torch.models.transformer import TransformerConfig

__all__ = ["CONFIG"]

CONFIG = ArchSpec(
    arch_id="qwen2-7b",
    family="lm",
    model_cfg=TransformerConfig(
        name="qwen2-7b", n_layers=28, d_model=3584, n_heads=28,
        n_kv_heads=4, head_dim=128, d_ff=18944, vocab=152064,
        qkv_bias=True, qk_norm=False, rope_base=1e6, dtype=torch.bfloat16),
    shapes=lm_shapes(),
    lss=LSSConfig(k_bits=10, n_tables=1),
    notes="LSS serves the 152064-wide LM head at decode.",
)
