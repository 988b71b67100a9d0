"""``slot_occupancy.<group>``: the mean share of the decode pool's slots
that hold a session, ``active`` over ``slots`` of each ``tick`` span
begun in the window (read at the tick's end)."""

import numpy as np

from wolbench.harness.spans import began


def read(ctx):
    ticks = [s for s in began(ctx, "tick") if s.args.get("slots")]
    if not ticks:
        return None
    return 100.0 * float(np.mean([s.args["active"] / s.args["slots"]
                                  for s in ticks]))
