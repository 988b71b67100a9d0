"""``rank_ms.<group>``: the median host ms of one ``Engine.rank`` call
and its answers' copy home (the harness's clock around each call
answered in the window)."""

import numpy as np


def read(ctx):
    t0, t1 = ctx.window
    ms = [(c[1] - c[0]) * 1e3 for c in ctx.calls_between(t0, t1)]
    return float(np.median(ms)) if ms else None
