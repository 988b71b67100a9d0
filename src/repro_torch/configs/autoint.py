"""autoint [recsys] n_sparse=39 embed_dim=16 n_attn_layers=3 n_heads=2
d_attn=32 interaction=self-attn [arXiv:1810.11921; paper] (counterpart of
``repro.configs.autoint``)."""

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.deepfm import _SHAPES
from repro_torch.models.recsys import CTRConfig

__all__ = ["CONFIG"]

CONFIG = ArchSpec(
    arch_id="autoint",
    family="recsys_ctr",
    model_cfg=CTRConfig(name="autoint", kind="autoint", n_fields=39,
                        vocab_per_field=1_000_000, embed_dim=16,
                        n_attn_layers=3, n_heads=2, d_attn=32),
    shapes=dict(_SHAPES),
    lss=None,
    notes="LSS inapplicable (binary CTR output).",
)
