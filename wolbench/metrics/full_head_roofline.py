"""``full_head_roofline``: the full-head step's share of its roofline:
the frozen bound of each call (W and b read once, 2*d*m operations a
query at the float32 peak, with the embedding bag's ids and rows, under
1% of it), averaged over the calls answered in the profiled window, over
the device time of every op in that window a call."""

from wolbench.cost import xc
from wolbench.harness.profiling import device_window


def read(ctx):
    w = device_window(ctx)
    if w is None or ctx.head != "full":
        return None
    calls = ctx.calls_between(ctx.prof.t0, ctx.prof.t1)
    if not calls:
        return None
    cfg = ctx.cfg
    bounds = []
    for c in calls:
        f = ctx.facts(c[3])
        bounds.append(xc.full_step_bound_s(
            f["rows"], cfg["max_in"], f["features"], f["distinct_features"],
            cfg["hidden"], cfg["output_dim"], cfg["top_k"]))
    device_s = sum(w["device_ns"].values()) / 1e9 / len(calls)
    return 100.0 * (sum(bounds) / len(bounds)) / device_s
