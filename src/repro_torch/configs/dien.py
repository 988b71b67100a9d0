"""dien [recsys] embed_dim=18 seq_len=100 gru_dim=108 mlp=200-80
interaction=augru [arXiv:1809.03672; unverified] (counterpart of
``repro.configs.dien``).

Item-sequence CTR: behavior history (100 items) -> GRU -> target
attention -> AUGRU.  Item vocab 2M (single huge table)."""

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.deepfm import _SHAPES
from repro_torch.models.recsys import CTRConfig

__all__ = ["CONFIG"]

CONFIG = ArchSpec(
    arch_id="dien",
    family="recsys_ctr",
    model_cfg=CTRConfig(name="dien", kind="dien", n_fields=1,
                        vocab_per_field=2_000_000, embed_dim=18,
                        seq_len=100, gru_dim=108, mlp_dims=(200, 80)),
    shapes=dict(_SHAPES),
    lss=None,
    notes="LSS inapplicable (binary CTR output).",
)
