"""``device_idle_unowned_pct.<group>``: the share of the profiled window
in which the device was idle while no host op and no program span was
open on any thread (the ``idle`` owner of the breakdown's idle gaps; 0
where it is not among them).  One reader for every group of cells."""

from wolbench.harness.profiling import device_window


def read(ctx):
    w = device_window(ctx)
    if w is None:
        return None
    idle_s = dict(w["idle_gaps"]).get("idle", 0.0)
    return 100.0 * idle_s / w["window_s"]
