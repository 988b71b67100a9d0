"""``device_idle_pct.<group>``: the share of the profiled window in which
no operation ran on the device (100 less the union of the device ops'
intervals over the window).  One reader for every group of cells."""

from wolbench.harness.profiling import device_window


def read(ctx):
    w = device_window(ctx)
    return None if w is None else 100.0 * (1.0 - w["busy_s"] / w["window_s"])
