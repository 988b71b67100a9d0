"""The program's ``obs`` spans of a run, as the metric readers read them:
the ring's finished spans (``repro_torch.obs.trace_export``), read once a
run and kept on its context, on the host clock (``time.perf_counter``
seconds, the clock of ``ctx.window``).  A program without a span of the
name asked for gives an empty list, and its readers None."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["Rec", "program_spans", "began", "ended", "under", "median_ms"]


class Rec(NamedTuple):
    name: str
    t0: float
    t1: float
    args: dict
    sid: int | None          # the span's own id; ``args["parent"]`` its
                             # parent's


def program_spans(ctx) -> list[Rec]:
    recs = getattr(ctx, "_program_spans", None)
    if recs is None:
        from repro_torch import obs
        recs = []
        for ev in obs.trace_export(include_open=False)["traceEvents"]:
            if ev["ph"] == "X":
                t0 = ev["ts"] / 1e6
                recs.append(Rec(ev["name"], t0, t0 + ev["dur"] / 1e6,
                                ev["args"], ev.get("id")))
        ctx._program_spans = recs
    return recs


def began(ctx, name: str) -> list[Rec]:
    """The spans named ``name`` that began in the window."""
    t0, t1 = ctx.window
    return [s for s in program_spans(ctx)
            if s.name == name and t0 <= s.t0 <= t1]


def ended(ctx, name: str) -> list[Rec]:
    """The spans named ``name`` that ended in the window."""
    t0, t1 = ctx.window
    return [s for s in program_spans(ctx)
            if s.name == name and t0 <= s.t1 <= t1]


def under(ctx, name: str, parent: str) -> list[Rec]:
    """The spans named ``name`` that began in the window inside a span
    named ``parent``."""
    names = {s.sid: s.name for s in program_spans(ctx) if s.name == parent}
    return [s for s in began(ctx, name)
            if names.get(s.args.get("parent")) == parent]


def median_ms(recs: list[Rec]) -> float | None:
    if not recs:
        return None
    return float(np.median([(s.t1 - s.t0) * 1e3 for s in recs]))
