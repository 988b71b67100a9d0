"""``mfu.<group>``: the useful operations of what the profiled window
served over its host-clock length and the chip's peak for the served
type.  XC cells (float32 peak): the rows answered in the window, each the
bag's adds, then the hash and the candidates the reference counts, or
the full head.  Decode cells (bf16 peak): the tokens that reached their
streams in the window, a first token carrying its prompt's prefill,
every later token its linear layers, its attention over its context and
the LSS head's hash and the candidates of its bucket in the reference's
index."""

import numpy as np

from wolbench.cost import lm, peaks, xc
from wolbench.harness.profiling import device_window
from wolbench.harness.window import stream_token_times


def read(ctx):
    if device_window(ctx) is None:
        return None
    return _xc(ctx) if ctx.kind == "xc" else _decode(ctx)


def _xc(ctx):
    calls = ctx.calls_between(ctx.prof.t0, ctx.prof.t1)
    if not calls:
        return None
    cfg, lss = ctx.cfg, ctx.cfg["lss"]
    total = 0
    for c in calls:
        f = ctx.facts(c[3])
        total += xc.batch_flops(
            f["rows"], f["features"], cfg["hidden"], ctx.head,
            m=cfg["output_dim"], k_bits=lss["k_bits"],
            n_tables=lss["n_tables"], scored=f.get("scored", 0))
    span = ctx.prof.t1 - ctx.prof.t0
    return 100.0 * total / (span * peaks.FP32_FLOPS)


def _decode(ctx):
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
                total += lm.prefill_flops(cfg, plen, lss["k_bits"],
                                          lss["n_tables"], n)
            else:
                total += lm.decode_token_flops(cfg, plen + j, lss["k_bits"],
                                               lss["n_tables"], n)
    return 100.0 * total / ((b - a) * peaks.BF16_FLOPS) if total else None
