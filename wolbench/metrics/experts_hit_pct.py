"""``experts_hit_pct.<group>``: the mean share of a layer's real experts
that a decode step's routing gave at least one token, over the ``tick``
spans begun in the window that carry the routing of the step they
collected: ``experts_hit`` (summed over the layers) over ``moe_layers``
times the configuration's ``num_experts``.  None where no tick carries
routing (a dense model, or a program without the counts)."""

import numpy as np

from wolbench.harness.spans import began


def read(ctx):
    if "num_experts" not in ctx.cfg:
        return None
    ticks = [s.args for s in began(ctx, "tick") if "experts_hit" in s.args]
    if not ticks:
        return None
    return 100.0 * float(np.mean([
        t["experts_hit"] / (t["moe_layers"] * ctx.cfg["num_experts"])
        for t in ticks]))
