"""bert4rec [recsys] embed_dim=64 n_blocks=2 n_heads=2 seq_len=200
interaction=bidir-seq [arXiv:1904.06690; paper] (counterpart of
``repro.configs.bert4rec``).

Item catalogue 1,000,000 (so retrieval_cand's n_candidates is the full
catalogue): the next-item softmax IS the paper's wide output layer, which
LSS serves (K = 12, L = 1)."""

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.core.lss import LSSConfig
from repro_torch.models.recsys import Bert4RecConfig

__all__ = ["CONFIG"]

CONFIG = ArchSpec(
    arch_id="bert4rec",
    family="recsys_seq",
    model_cfg=Bert4RecConfig(name="bert4rec", n_items=1_000_000,
                             embed_dim=64, n_blocks=2, n_heads=2,
                             seq_len=200),
    shapes={
        "train_batch": ShapeSpec("train_batch", "train", {"batch": 65536}),
        "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 512}),
        "serve_bulk": ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
        "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                    {"batch": 1, "n_candidates": 1000000}),
    },
    lss=LSSConfig(k_bits=12, n_tables=1),
    notes="LSS serves the 1M-item catalogue WOL.",
)
