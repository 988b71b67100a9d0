"""qwen2-moe-a2.7b [moe] 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4 -- 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf] (counterpart of
``repro.configs.qwen2_moe_a2_7b``).

60 experts padded to 64 physical experts (the router masks the 4 pads;
see models/moe.py).  The "4 shared" experts are fused into one shared
SwiGLU of hidden 4*1408=5632 with a sigmoid gate, as the HF reference
implementation does.
"""

import torch

from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.core.lss import LSSConfig
from repro_torch.models.transformer import TransformerConfig

__all__ = ["CONFIG"]

CONFIG = ArchSpec(
    arch_id="qwen2-moe-a2.7b",
    family="lm",
    model_cfg=TransformerConfig(
        name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=16, head_dim=128, d_ff=1408, vocab=151936,
        qkv_bias=True, rope_base=1e6, dtype=torch.bfloat16,
        moe_style="replace", n_experts=60, n_experts_padded=64,
        moe_top_k=4, moe_d_ff=1408, shared_expert_ff=5632),
    shapes=lm_shapes(),
    lss=LSSConfig(k_bits=10, n_tables=1),
)
