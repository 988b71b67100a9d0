"""ArchSpec: one selectable architecture = model config + its shape set
+ LSS applicability (counterpart of ``repro.configs.base``)."""

from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.core.lss import LSSConfig

__all__ = ["ShapeSpec", "ArchSpec", "lm_shapes"]


class ShapeSpec(NamedTuple):
    name: str
    kind: str          # train | prefill | decode | serve | retrieval | ...
    dims: dict         # family-specific sizes


class ArchSpec(NamedTuple):
    arch_id: str
    family: str        # lm | gnn | recsys_ctr | recsys_seq
    model_cfg: Any
    shapes: dict[str, ShapeSpec]
    lss: LSSConfig | None = None   # None => paper's technique inapplicable
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        return self.shapes[name]


def lm_shapes() -> dict[str, ShapeSpec]:
    """The four LM shapes shared by every LM arch."""
    return {
        "train_4k": ShapeSpec("train_4k", "train",
                              {"seq_len": 4096, "global_batch": 256}),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                                 {"seq_len": 32768, "global_batch": 32}),
        "decode_32k": ShapeSpec("decode_32k", "decode",
                                {"seq_len": 32768, "global_batch": 128}),
        "long_500k": ShapeSpec("long_500k", "decode",
                               {"seq_len": 524288, "global_batch": 1}),
    }
