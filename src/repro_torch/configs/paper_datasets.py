"""The paper's extreme-classification settings (counterpart of
``repro.configs.paper_datasets``; Table 4 / Appendix B).

``full`` configs carry the paper's dimensions.  The JAX package's
reduced ``bench`` stand-ins and IUL settings come with the training
slices that read them; ``WIKITEXT2`` waits for the port of
``models/lstm.py``.
"""

from typing import NamedTuple

from repro_torch.core.lss import LSSConfig
from repro_torch.models.xc import XCConfig

__all__ = ["PaperSetting", "WIKI10", "DELICIOUS", "TEXT8", "ALL"]


class PaperSetting(NamedTuple):
    name: str
    kind: str               # xc | word2vec
    full: XCConfig
    lss: LSSConfig


WIKI10 = PaperSetting(
    name="wiki10-31k", kind="xc",
    full=XCConfig("wiki10-31k", input_dim=101938, hidden=128,
                  output_dim=30938, max_in=64, max_labels=8),
    lss=LSSConfig(k_bits=6, n_tables=1),
)

DELICIOUS = PaperSetting(
    name="delicious-200k", kind="xc",
    full=XCConfig("delicious-200k", input_dim=782585, hidden=128,
                  output_dim=205443, max_in=64, max_labels=8),
    lss=LSSConfig(k_bits=9, n_tables=1),
)

TEXT8 = PaperSetting(
    name="text8", kind="word2vec",
    full=XCConfig("text8", input_dim=1355336, hidden=128,
                  output_dim=1355336, max_in=1, max_labels=50),
    lss=LSSConfig(k_bits=11, n_tables=1),
)

ALL = {s.name: s for s in (WIKI10, DELICIOUS, TEXT8)}
