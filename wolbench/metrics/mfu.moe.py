"""``mfu.moe``: the useful operations of what the profiled window served
over its host-clock length and the bf16 peak, for a sparse-expert
decoder: the tokens that reached their streams in the window, a first
token carrying its prompt's prefill, every later token the linear layers
it uses (attention, the router, the shared expert and its gate, its
top-k experts: ``cost/moe.py``), its attention over its context and the
LSS head's hash and the candidates of its bucket in the reference's
index.  The whole step's share of the card's peak."""

import numpy as np

from wolbench.cost import moe, peaks
from wolbench.harness.profiling import device_window
from wolbench.harness.window import stream_token_times


def read(ctx):
    if device_window(ctx) is None or "num_experts" not in ctx.cfg:
        return None
    a, b = ctx.prof.t0, ctx.prof.t1
    cfg, lss = ctx.cfg, ctx.cfg["lss"]
    total = 0.0
    for s in ctx.sessions:
        times = stream_token_times(s.record)
        inside = np.flatnonzero((times >= a) & (times <= b))
        if not inside.size:
            continue
        plen = len(s.prompt)
        for j, n in zip(inside, ctx.scored(s.tokens[inside])):
            if j == 0:
                total += moe.prefill_flops(cfg, plen, lss["k_bits"],
                                           lss["n_tables"], n)
            else:
                total += moe.decode_token_flops(cfg, plen + j,
                                                lss["k_bits"],
                                                lss["n_tables"], n)
    return 100.0 * total / ((b - a) * peaks.BF16_FLOPS) if total else None
