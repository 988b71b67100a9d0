"""Tiny stand-ins of the benchmark's cells for CPU tests: each cell's own
configuration and mix with the sizes cut, the limits kept."""

import time

import torch

from wolbench.harness import spec

_XC = {"input_dim": 3000, "hidden": 16, "output_dim": 800, "max_in": 8,
       "lss": {"k_bits": 4, "n_tables": 1, "capacity": 104,
               "slab_dtype": "fp32"},
       "buckets": [1, 2, 4, 8, 16, 32],
       "init": {"embed_std": 3000 ** -0.5, "w_std": 0.25, "b_std": 0.01}}
# six layers: the fp8 control's error has to build up to fail the limits
_LM = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
       "num_key_value_heads": 2, "num_hidden_layers": 6, "head_dim": 16,
       "vocab_size": 512,
       "lss": {"k_bits": 4, "n_tables": 1, "capacity": 64,
               "slab_dtype": "fp32"}}
_BULK = {"clients": 2, "batch_rows": 32, "pool_batches": 8,
         "features": [2, 8], "topics": 8, "check_every": 2,
         "trace_seconds": 0.3}
_SESSIONS = {"slots": 4, "clients": 4, "prompt_tokens": [8, 24],
             "output_tokens": [8, 16], "pool_sessions": 256, "topics": 4,
             "page_tokens": 8, "check_sessions": 64, "trace_seconds": 0.3}


class TinyCell:
    """A cell of ``BENCHMARK.json`` at a size a CPU runs in a second."""

    def __init__(self, name: str):
        real = spec.find_cell(name)
        self.name, self.entry, self.chips = name, real.entry, 1
        self.end_to_end, self.per_layer = real.end_to_end, real.per_layer
        kind = real.config["kind"]
        self.config = dict(real.config, **(_XC if kind == "xc" else _LM))
        self.mix = dict(real.mix, **(_BULK if real.mix["kind"] == "bulk"
                                     else _SESSIONS))

    def run(self, seed=7, seconds=1.0, trace=False, control=False):
        import importlib
        driver = importlib.import_module(
            f"wolbench.harness.{self.config['kind']}_cell")
        torch.set_num_threads(2)
        return driver.run(self, seed, seconds, trace, torch.device("cpu"),
                          time.perf_counter(), control=control)
