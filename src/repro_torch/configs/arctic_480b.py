"""arctic-480b [moe] 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128e top-2 -- 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf] (counterpart of
``repro.configs.arctic_480b``).

Dense-residual MoE: every layer runs a dense SwiGLU (d_ff=4864) IN
PARALLEL with the 128-expert top-2 MoE (moe_style="parallel").  The
expert tensors' specs put experts over 'model' and d_ff over 'data'
(moe_fsdp).  One layer is 13.6 B parameters (27.2 GB in bf16), so one
H100 holds the full width at one layer, not the full depth.
"""

import torch

from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.core.lss import LSSConfig
from repro_torch.models.transformer import TransformerConfig

__all__ = ["CONFIG"]

CONFIG = ArchSpec(
    arch_id="arctic-480b",
    family="lm",
    model_cfg=TransformerConfig(
        name="arctic-480b", n_layers=35, d_model=7168, n_heads=56,
        n_kv_heads=8, head_dim=128, d_ff=4864, vocab=32000,
        qkv_bias=False, rope_base=1e6, dtype=torch.bfloat16,
        moe_style="parallel", n_experts=128, n_experts_padded=128,
        moe_top_k=2, moe_d_ff=4864, moe_fsdp=True),
    shapes=lm_shapes(),
    lss=LSSConfig(k_bits=8, n_tables=1),
    notes="Optimizer state bf16 (memory); vocab 32000 -> K=8 LSS head.",
)
