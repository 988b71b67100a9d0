"""``step_roofline.<group>``: a sparse-expert decode step's share of its
byte bound over the profiled window.  The bytes (``cost/moe.py``): for
each decode step whose ``tick`` span began and ended in the window and
carries the routing of the step it collected, the weights every step
reads (attention, shared expert, router) and the routed experts it hit
(``experts_hit``, summed over the layers); for each token that reached
its stream in the window after its first (a decode step made it), its
K and V over ``plen + j`` positions and its bucket's LSS slab rows.  At
3.35 TB/s, over the device's busy time in the window (every op, prefill
included), so the share stays under 100%.  None where no tick carries
routing (a dense model, or a program without the counts), no op ran on
the device, or the run was untraced."""

import numpy as np

from wolbench.cost import moe, peaks
from wolbench.harness.profiling import device_window
from wolbench.harness.spans import program_spans
from wolbench.harness.window import stream_token_times


def read(ctx):
    w = device_window(ctx)
    if w is None or "num_experts" not in ctx.cfg:
        return None
    a, b = ctx.prof.t0, ctx.prof.t1
    cfg = ctx.cfg
    hits = [s.args["experts_hit"] for s in program_spans(ctx)
            if s.name == "tick" and a <= s.t0 and s.t1 <= b
            and "experts_hit" in s.args]
    if not hits:
        return None
    total = (len(hits) * moe.step_weight_bytes(cfg)
             + sum(hits) * moe.expert_bytes(cfg))
    per_position = moe.kv_bytes_per_position(cfg)
    for s in ctx.sessions:
        times = stream_token_times(s.record)
        inside = np.flatnonzero((times >= a) & (times <= b))
        inside = inside[inside >= 1]
        if not inside.size:
            continue
        total += int((len(s.prompt) + inside).sum()) * per_position
        total += float(moe.scored_bytes(
            cfg, ctx.scored(s.tokens[inside]).sum()))
    return 100.0 * total / peaks.HBM_BYTES_PER_S / w["busy_s"]
