"""``lss_topk_roofline``: the ``lss_topk`` kernel's share of its
roofline: the frozen bound of each call (each distinct slab the batch
hits read once, as the reference hashes the batch), averaged over the
calls answered in the profiled window, over the kernel's mean device
time there."""

from wolbench.cost import xc
from wolbench.harness.profiling import device_window


def read(ctx):
    w = device_window(ctx)
    if w is None or ctx.head == "full":
        return None
    names = [n for n in w["device_ns"] if "lss_topk" in n]
    count = sum(w["device_count"][n] for n in names)
    calls = ctx.calls_between(ctx.prof.t0, ctx.prof.t1)
    if not count or not calls:
        return None
    kernel_s = sum(w["device_ns"][n] for n in names) / 1e9 / count
    cfg, lss = ctx.cfg, ctx.cfg["lss"]
    bounds = []
    for c in calls:
        f = ctx.facts(c[3])
        bounds.append(xc.lss_topk_bound_s(
            f["rows"], cfg["hidden"] + 1, lss["k_bits"], lss["n_tables"],
            lss["capacity"], f["distinct_slabs"], f["distinct_occupied"],
            f["scored"], cfg["top_k"]))
    return 100.0 * (sum(bounds) / len(bounds)) / kernel_s
