"""Window arithmetic, from host timestamps (``time.perf_counter``
seconds): what completed inside ``[t0, t1]`` over the window's length,
and tails over every sample in it.  A percentile is numpy's, linearly
interpolated."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

__all__ = ["StreamRecord", "p95", "bulk_window", "stream_token_times",
           "decode_window"]


def p95(values) -> float | None:
    v = np.asarray(values, np.float64)
    return None if v.size == 0 else float(np.percentile(v, 95))


def bulk_window(calls: Sequence[tuple[float, float, int]], t0: float,
                t1: float) -> dict:
    """``calls``: ``(t_sent, t_answered, rows)``.  The rows whose answers
    reached their client inside the window, over the window."""
    rows = sum(r for _, t, r in calls if t0 <= t <= t1)
    return {"rows": rows, "queries_per_s": rows / (t1 - t0)}


class StreamRecord(NamedTuple):
    """One session as its client saw it."""

    t_submit: float
    ttft_s: float | None          # None before the first token
    gaps_s: np.ndarray            # gaps between its later tokens


def stream_token_times(rec: StreamRecord) -> np.ndarray:
    """Absolute arrival times of a stream's tokens."""
    if rec.ttft_s is None:
        return np.zeros(0)
    first = rec.t_submit + rec.ttft_s
    return first + np.concatenate([[0.0], np.cumsum(rec.gaps_s)])


def decode_window(records: Sequence[StreamRecord], t0: float, t1: float
                  ) -> dict:
    """Tokens that reached their streams inside the window over its
    length; the p95 of every gap that ended inside it; the p95 of the
    time to first token of every session whose first token landed in
    it, from its submit."""
    n_tokens, gaps, ttfts = 0, [], []
    for rec in records:
        times = stream_token_times(rec)
        inside = (times >= t0) & (times <= t1)
        n_tokens += int(inside.sum())
        if times.size > 1:
            gaps.append(np.diff(times)[inside[1:]])
        if times.size and inside[0]:
            ttfts.append(rec.ttft_s)
    gaps_all = np.concatenate(gaps) if gaps else np.zeros(0)
    itl = p95(gaps_all)
    ttft = p95(ttfts)
    return {"tokens": n_tokens, "tokens_per_s": n_tokens / (t1 - t0),
            "gaps": int(gaps_all.size), "first_tokens": len(ttfts),
            "itl_p95_ms": None if itl is None else itl * 1e3,
            "ttft_p95_ms": None if ttft is None else ttft * 1e3}
