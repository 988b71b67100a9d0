"""``tick_ms.<group>``: the median of the decode scheduler's ``tick``
spans that began in the window, each less the ``prefill`` spans inside
it: the host time of one admit-dispatch-collect round without prompts."""

import numpy as np


def read(ctx):
    t0, t1 = ctx.window
    ticks = [s for s in ctx.spans if s[0] == "tick" and t0 <= s[1] <= t1]
    if not ticks:
        return None
    pre = sorted((s[1], s[2]) for s in ctx.spans if s[0] == "prefill")
    starts = np.array([p[0] for p in pre])
    out = []
    for _, a, b, _ in ticks:
        lo, hi = np.searchsorted(starts, [a, b])
        inner = sum(min(e, b) - s for s, e in pre[lo:hi])
        out.append((b - a - inner) * 1e3)
    return float(np.median(out))
