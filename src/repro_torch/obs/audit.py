"""Online label-recall auditor: the paper's LSS claim as a live SLO
(counterpart of ``repro.obs.audit``).

This module measures *continuously on live traffic* how much of the
exact brute-force WOL top-k the LSS head retrieves.  A sampled fraction
(``REPRO_OBS_AUDIT_RATE``) of LSS-served scoring groups is re-ranked
through the exact full head — on the engine's existing step table (a
captured CUDA graph per bucket on the card), so the audit pays one
extra step per sampled group and builds no new kind of step — on a
low-priority daemon thread, fully off the dispatch hot path.

Recall uses the bench's exact definition (hit = exact top-k id present
in the served id set, averaged over rows x k), accumulated as integer
``hits / total`` — so at ``REPRO_OBS_AUDIT_RATE=1.0`` the published
gauge reproduces the offline brute-force recall exactly, not to
sampling noise.  Published metrics (global registry):

  * ``lss_audit_recall_at_k``     live recall@k gauge
  * ``lss_audit_top1_recall``     overlap of the exact top-1 id
  * ``lss_audit_rows_total``      rows audited
  * ``lss_audit_dropped_total``   sampled groups shed because the audit
    backlog was full — the *staleness* signal: when it grows, the gauge
    lags live traffic
  * ``lss_audit_backlog``         current queue depth

The backlog is bounded (default 64 groups) and ``offer`` never blocks:
under overload the auditor degrades to stale, never slows serving.
This is the sensor an online index refresh needs to catch post-refit
recall regressions.
"""

from __future__ import annotations

import queue
import random
import threading

import numpy as np

from repro_torch import obs
from repro_torch.device import HostOutput

__all__ = ["RecallAuditor"]

_SENTINEL = object()


def _host_ids(ids) -> np.ndarray:
    """Ids as a numpy array; a tensor comes through a pinned copy that is
    waited for on its own event, not on the whole stream."""
    if isinstance(ids, np.ndarray):
        return ids
    return HostOutput((ids,)).wait()[0]


class RecallAuditor:
    """Samples served groups, re-ranks via the exact full head, and
    publishes live recall gauges.  Construct with ``rate=0`` for a
    disabled auditor (every method is a cheap no-op)."""

    def __init__(self, engine, rate: float, *, queue_cap: int = 64,
                 registry=None, seed: int = 0):
        self.engine = engine
        self.rate = min(1.0, max(0.0, float(rate)))
        self.reg = registry if registry is not None else obs.registry()
        self._rng = random.Random(seed)
        self._mu = threading.Lock()
        self._hits = 0
        self._total = 0
        self._top1_hits = 0
        self._top1_total = 0
        self._g_recall = self.reg.gauge(
            "lss_audit_recall_at_k",
            "live label recall@k of LSS-served requests vs the exact "
            "full head")
        self._g_top1 = self.reg.gauge(
            "lss_audit_top1_recall",
            "live overlap of the exact top-1 label with the served set")
        self._g_backlog = self.reg.gauge(
            "lss_audit_backlog", "sampled groups awaiting audit")
        self._c_rows = self.reg.counter(
            "lss_audit_rows_total", "rows re-ranked by the auditor")
        self._c_dropped = self.reg.counter(
            "lss_audit_dropped_total",
            "sampled groups shed (audit backlog full) - staleness signal")
        self._q: queue.Queue = queue.Queue(maxsize=queue_cap)
        self._thread: threading.Thread | None = None
        if self.rate > 0:
            self._thread = threading.Thread(target=self._worker,
                                            name="repro-obs-audit",
                                            daemon=True)
            self._thread.start()

    # ------------------------------------------------------------ hot path --
    def offer(self, x, served_ids: np.ndarray) -> bool:
        """Maybe enqueue one served group for audit.  Called from the
        dispatch path right after results are sliced: coin-flips the
        sample, then a non-blocking put — NEVER stalls serving.  ``x``
        may be a thunk (the group pytree is only materialized when the
        flip samples it).  Returns True iff the group was enqueued."""
        if self.rate <= 0 or self._thread is None:
            return False
        if self.rate < 1.0 and self._rng.random() >= self.rate:
            return False
        if callable(x):
            x = x()
        try:
            self._q.put_nowait((x, np.asarray(served_ids)))
        except queue.Full:
            self._c_dropped.inc()
            obs.event("audit_drop", backlog=self._q.qsize())
            return False
        self._g_backlog.set(self._q.qsize())
        return True

    # ------------------------------------------------------------- worker --
    def _worker(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _SENTINEL:
                    return
                x, served = item
                try:
                    self._audit_one(x, served)
                except Exception as exc:      # audit must never take the
                    obs.event("audit_error",  # serving process down
                              error=repr(exc))
            finally:
                self._q.task_done()
                self._g_backlog.set(self._q.qsize())

    def _audit_one(self, x, served: np.ndarray) -> None:
        span = obs.start_span("audit", rows=int(served.shape[0]),
                              k=int(served.shape[1]))
        try:
            # exact reference: the SAME weights through the engine's
            # full head (one step per bucket, reused across audits);
            # _host_ids waits for this step's outputs only
            out = self.engine.rank(x, head="full", record=False)
            exact = _host_ids(out.ids)            # [B, k] brute-force ids
            hit = (exact[:, :, None] == served[:, None, :]).any(-1)
            with self._mu:
                self._hits += int(hit.sum())
                self._total += hit.size
                self._top1_hits += int(hit[:, 0].sum())
                self._top1_total += hit.shape[0]
                hits, total = self._hits, self._total
                t1h, t1t = self._top1_hits, self._top1_total
            self._g_recall.set(hits / total)
            self._g_top1.set(t1h / t1t)
            self._c_rows.inc(served.shape[0])
            span.end("ok", recall=hits / total)
        except BaseException as exc:
            span.end_from_exc(exc)
            raise

    # ------------------------------------------------------------ control --
    @property
    def recall(self) -> float:
        """Cumulative recall@k over every audited row (nan if none)."""
        with self._mu:
            return self._hits / self._total if self._total else float("nan")

    @property
    def n_rows(self) -> int:
        with self._mu:
            return self._top1_total

    def snapshot(self) -> tuple[int, int]:
        """Atomic ``(hits, total)`` — windowed consumers (the refresher's
        probation watch) subtract two snapshots to get recall over just
        the rows audited in between, instead of the cumulative gauge."""
        with self._mu:
            return self._hits, self._total

    def drain(self, timeout: float = 30.0) -> None:
        """Block until every enqueued group has been audited (tests use
        this to read a settled gauge)."""
        if self._thread is None:
            return
        import time
        deadline = time.monotonic() + timeout
        while self._q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.005)

    def close(self) -> None:
        if self._thread is None:
            return
        self._q.put(_SENTINEL)
        self._thread.join(timeout=10.0)
        self._thread = None
