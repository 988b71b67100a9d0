"""The paper's own four evaluation settings (counterpart of
``repro.configs.paper_datasets``; Table 4 / Appendix B).

``full`` configs carry the paper's dimensions; ``bench`` configs are the
JAX package's reduced stand-ins, and ``bench_lss`` their IUL settings.
"""

from typing import NamedTuple

from repro_torch.core.lss import LSSConfig
from repro_torch.models.lstm import LSTMConfig
from repro_torch.models.xc import XCConfig

__all__ = ["PaperSetting", "WIKI10", "DELICIOUS", "TEXT8", "WIKITEXT2",
           "ALL"]


class PaperSetting(NamedTuple):
    name: str
    kind: str               # xc | word2vec | lstm
    full: XCConfig | LSTMConfig
    bench: XCConfig | LSTMConfig
    lss: LSSConfig
    bench_lss: LSSConfig


WIKI10 = PaperSetting(
    name="wiki10-31k", kind="xc",
    full=XCConfig("wiki10-31k", input_dim=101938, hidden=128,
                  output_dim=30938, max_in=64, max_labels=8),
    bench=XCConfig("wiki10-31k-bench", input_dim=8000, hidden=64,
                   output_dim=4000, max_in=32, max_labels=4),
    lss=LSSConfig(k_bits=6, n_tables=1),
    bench_lss=LSSConfig(k_bits=4, n_tables=1, iul_epochs=10,
                        iul_inner_steps=10, iul_lr=0.02),
)

DELICIOUS = PaperSetting(
    name="delicious-200k", kind="xc",
    full=XCConfig("delicious-200k", input_dim=782585, hidden=128,
                  output_dim=205443, max_in=64, max_labels=8),
    bench=XCConfig("delicious-200k-bench", input_dim=12000, hidden=64,
                   output_dim=8000, max_in=32, max_labels=4),
    lss=LSSConfig(k_bits=9, n_tables=1),
    bench_lss=LSSConfig(k_bits=5, n_tables=1, iul_epochs=10,
                        iul_inner_steps=10, iul_lr=0.02),
)

TEXT8 = PaperSetting(
    name="text8", kind="word2vec",
    full=XCConfig("text8", input_dim=1355336, hidden=128,
                  output_dim=1355336, max_in=1, max_labels=50),
    bench=XCConfig("text8-bench", input_dim=20000, hidden=64,
                   output_dim=20000, max_in=1, max_labels=10),
    lss=LSSConfig(k_bits=11, n_tables=1),
    bench_lss=LSSConfig(k_bits=6, n_tables=1, iul_epochs=8,
                        iul_inner_steps=10, iul_lr=0.02),
)

WIKITEXT2 = PaperSetting(
    name="wiki-text-2", kind="lstm",
    full=LSTMConfig("wiki-text-2", vocab=50000, hidden=200, n_layers=2),
    bench=LSTMConfig("wiki-text-2-bench", vocab=8000, hidden=96,
                     n_layers=2),
    lss=LSSConfig(k_bits=8, n_tables=1),
    bench_lss=LSSConfig(k_bits=5, n_tables=1, iul_epochs=8,
                        iul_inner_steps=10, iul_lr=0.02),
)

ALL = {s.name: s for s in (WIKI10, DELICIOUS, TEXT8, WIKITEXT2)}
