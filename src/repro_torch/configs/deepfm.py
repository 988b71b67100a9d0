"""deepfm [recsys] n_sparse=39 embed_dim=10 mlp=400-400-400
interaction=fm [arXiv:1703.04247; paper] (counterpart of
``repro.configs.deepfm``).

Unified embedding table: 39 fields x 1M rows = 39M rows x dim 10,
row-sharded over 'model' in its specs.  LSS inapplicable to the 1-logit
CTR output.
"""

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.models.recsys import CTRConfig

__all__ = ["CONFIG"]

_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", {"batch": 65536}),
    "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                {"batch": 1, "n_candidates": 1000000}),
}

CONFIG = ArchSpec(
    arch_id="deepfm",
    family="recsys_ctr",
    model_cfg=CTRConfig(name="deepfm", kind="deepfm", n_fields=39,
                        vocab_per_field=1_000_000, embed_dim=10,
                        mlp_dims=(400, 400, 400)),
    shapes=dict(_SHAPES),
    lss=None,
    notes="LSS inapplicable (binary CTR output).",
)
