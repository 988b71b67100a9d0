"""``prefill_ms.<group>``: the median of the ``prefill`` spans that began
in the window (a prompt's eager prefill, its KV join and its first
token's head)."""

import numpy as np


def read(ctx):
    t0, t1 = ctx.window
    ms = [(s[2] - s[1]) * 1e3 for s in ctx.spans
          if s[0] == "prefill" and t0 <= s[1] <= t1]
    return float(np.median(ms)) if ms else None
