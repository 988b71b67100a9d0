"""``queue_p90_ms.<group>``: the p90 (numpy's, linearly interpolated) of
the ``queue`` spans that ended in the window: a decode session's wait
from its submit until the scheduler takes it for a slot, before its
prefill."""

import numpy as np

from wolbench.harness.spans import ended


def read(ctx):
    ms = [(s.t1 - s.t0) * 1e3 for s in ended(ctx, "queue")]
    return float(np.percentile(ms, 90)) if ms else None
