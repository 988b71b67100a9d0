"""qwen3-4b [dense] 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf] (counterpart of
``repro.configs.qwen3_4b``: its model and LSS configs; the ``ArchSpec``
and its shapes come with the launch code)."""

import torch

from repro_torch.core.lss import LSSConfig
from repro_torch.models.transformer import TransformerConfig

__all__ = ["CONFIG", "LSS"]

CONFIG = TransformerConfig(
    name="qwen3-4b", n_layers=36, d_model=2560, n_heads=32,
    n_kv_heads=8, head_dim=128, d_ff=9728, vocab=151936,
    qkv_bias=False, qk_norm=True, rope_base=1e6, dtype=torch.bfloat16)

LSS = LSSConfig(k_bits=10, n_tables=1)
