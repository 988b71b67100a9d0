"""A tiny stand-in of the sparse-expert cell for CPU tests:
``TinyCell``'s cut of the decoder with the experts cut too (6 of width
32, held as 8, top-2; a shared expert of width 48), the limits kept."""

from wolbench.tests.tiny import TinyCell

CELL = "qwen2-moe-a2.7b-lss-reason"
_MOE = {"num_experts": 6, "n_experts_padded": 8, "num_experts_per_tok": 2,
        "moe_intermediate_size": 32, "shared_expert_intermediate_size": 48}


class TinyMoECell(TinyCell):
    def __init__(self, name: str = CELL):
        super().__init__(name)
        self.config = dict(self.config, **_MOE)
