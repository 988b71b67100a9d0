"""Background index refresh with guarded swap and automatic rollback
(counterpart of ``repro.serve.refresh.refresher``).

State machine (one ``refresh_once`` cycle)::

    IDLE --interval--> REFIT --ok--> SWAP --probation ok--> IDLE
                         |             |
                         | exception / |  audited recall dropped more
                         | NaN theta   |  than rollback_delta below the
                         v             v  pre-swap baseline
                       FAILED        ROLLBACK --> IDLE
                  (backoff, park       (swap BACK to the previous
                   after max_failures)  index as a NEW epoch)

Everything expensive — IUL epochs, ``build_index``, capturing the new
epoch's steps — happens before the swap, which itself is the O(1) epoch
flip of ``Engine._swap_prepared``.  The refit runs on the refresher
thread's current stream (the default stream unless the caller sets
another), in order with the serving replays queued there.  Failures never
propagate to the serving path: the engine keeps serving the epoch it
already has (graceful degradation), and repeated failures back off
exponentially until the refresher parks itself.

Probation is judged by the :class:`~repro_torch.obs.audit.RecallAuditor`:
the refresher snapshots ``(hits, total)`` at the swap and compares the
recall of ONLY the rows audited after it against the pre-swap baseline
— the cumulative gauge would dilute a regression by history.

Fault-injection hook points (``repro_torch.testing.faults``):
``refresh.refit`` before the refit computes, ``refresh.built`` after the
candidate is built (a callable may substitute a corrupted index), and
``refresh.probation`` at each probation poll (a callable may override
``ctx["recall"]``).
"""

from __future__ import annotations

import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import simhash
from repro_torch.core.iul import IULState, iul_init, iul_refit_epoch
from repro_torch.testing import faults

__all__ = ["IndexRefresher", "RefreshConfig"]

_UNSET = object()


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return default if v in (None, "") else float(v)


class RefreshConfig(NamedTuple):
    """Knobs for the refresh loop (env overrides in :meth:`from_env`,
    documented in docs/KERNELS.md)."""

    interval_s: float = 30.0        # sleep between refresh cycles
    probation_s: float = 5.0        # watch window after each swap
    rollback_delta: float = 0.05    # tolerated recall drop vs baseline
    min_audit_rows: int = 64        # rows before probation can judge
    probation_poll_s: float = 0.25  # auditor poll cadence
    epochs_per_refresh: int = 1     # IUL epochs per cycle
    max_failures: int = 5           # consecutive failures before parking
    backoff_base_s: float = 1.0     # first retry delay
    backoff_max_s: float = 60.0     # retry delay ceiling
    warm: bool = True               # pre-build the new epoch's steps

    @classmethod
    def from_env(cls, **overrides) -> "RefreshConfig":
        base = cls(
            interval_s=_env_float("REPRO_REFRESH_INTERVAL", cls().interval_s),
            probation_s=_env_float("REPRO_REFRESH_PROBATION",
                                   cls().probation_s),
            rollback_delta=_env_float("REPRO_REFRESH_ROLLBACK_DELTA",
                                      cls().rollback_delta),
        )
        return base._replace(**overrides) if overrides else base


class IndexRefresher:
    """Serve while you re-learn the hash.

    Args:
      engine: the serving Engine.  Must have been fitted through
        ``fit_from_queries`` (the refresher snapshots ``engine.calib``)
        or be given ``calib=(q, labels)`` explicitly.  On a multihost
        fleet, construct this on the LEADER only — ``swap_index`` ships
        ``OP_SWAP_INDEX`` (``multihost.leader_swap_index``) so followers
        flip in lockstep; a follower refuses to construct one.
      auditor: the live recall sensor probation watches.  ``None``
        disables the guard (swaps are trusted); a disabled auditor
        (``rate=0``) behaves like ``None`` because no rows ever arrive
        inside the probation window.
      cfg: :class:`RefreshConfig`.
      calib: optional ``(q, labels)`` calibration snapshot override.
      seed: seed of the ``torch.Generator`` (on the engine's device) that
        draws the resumed IUL stream's batch orders.

    ``n_failed`` counts every failed cycle (``n_failures`` only the
    consecutive ones), and ``last_error`` holds ``repr`` of the last
    failed cycle's exception (None after a cycle that did not fail),
    since ``refresh_once`` never raises.

    The training stream RESUMES from the serving hyperplanes
    (``iul_init(theta=index.theta)``) and carries optimizer state across
    cycles — each refresh is a continuation, not a cold restart.
    """

    def __init__(self, engine, auditor=_UNSET,
                 cfg: RefreshConfig | None = None,
                 *, calib=None, seed: int = 0, registry=None):
        self.engine = engine
        # default: the engine's own auditor (None and rate-0 both mean
        # "no guard" — probation then passes on no-evidence)
        self.auditor = (getattr(engine, "auditor", None)
                        if auditor is _UNSET else auditor)
        self.cfg = cfg if cfg is not None else RefreshConfig.from_env()
        spmd = getattr(engine, "spmd", None)
        if spmd is not None and not spmd.is_leader:
            raise RuntimeError("IndexRefresher runs on the multihost "
                               "leader; followers swap via OP_SWAP_INDEX")
        if calib is None:
            calib = engine.calib
        if calib is None:
            raise RuntimeError(
                "engine has no calibration snapshot: fit with "
                "fit_from_queries() or pass calib=(q, labels)")
        q, labels = calib
        dev = engine.device
        # freeze the snapshot ONCE, as device copies: the refit must see
        # an immutable view no matter what the caller does afterwards
        self._q_aug = simhash.augment_queries(
            torch.as_tensor(q, device=dev).float().detach()).clone()
        self._labels = torch.as_tensor(labels, device=dev).clone()
        self._w_aug = engine._w_aug
        self._seed = seed
        self._state: IULState | None = None     # lazy: needs a fitted index
        self.n_refreshes = 0
        self.n_rollbacks = 0
        self.n_failures = 0                     # consecutive, resets on ok
        self.n_failed = 0                       # every failed cycle
        self.parked = False
        self.last_info: dict = {}
        self.last_error: str | None = None
        self.reg = registry if registry is not None else obs.registry()
        self._c_total = self.reg.counter(
            "lss_refresh_total", "refresh cycles attempted")
        self._c_swapped = self.reg.counter(
            "lss_refresh_swapped_total", "refresh cycles that swapped")
        self._c_rollback = self.reg.counter(
            "lss_refresh_rollback_total",
            "swaps reverted because audited recall regressed")
        self._c_failures = self.reg.counter(
            "lss_refresh_failures_total", "refresh cycles that failed")
        self._g_epoch = self.reg.gauge(
            "lss_refresh_index_epoch", "engine epoch serving now")
        self._g_recall = self.reg.gauge(
            "lss_refresh_calib_recall",
            "calibration recall of the last candidate index")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ refit --
    def _refit(self):
        """Run the configured IUL epochs off the hot path; return the
        candidate index (NaN-guarded) and its calibration recall."""
        faults.fire(faults.REFRESH_REFIT)
        if self._state is None:
            idx = self.engine.index
            if idx is None:
                raise RuntimeError("refresh needs a fitted engine")
            gen = torch.Generator(self.engine.device).manual_seed(
                self._seed)
            with torch.no_grad():
                self._state = iul_init(gen, self._q_aug, self._labels,
                                       self._w_aug, self.engine.lss_cfg,
                                       theta=idx.theta)
        index = self.engine.index
        info = {}
        with torch.no_grad():        # the epochs enable grad for θ alone
            for _ in range(max(1, self.cfg.epochs_per_refresh)):
                self._state, index, info = iul_refit_epoch(
                    self._state, self._q_aug, self._labels, self._w_aug,
                    index, self.engine.lss_cfg)
        if not bool(torch.isfinite(self._state.theta).all()):
            raise FloatingPointError(
                "refit produced non-finite hyperplanes (diverged); "
                "keeping the serving index")
        self.last_info = info
        return index, float(info.get("recall", float("nan")))

    # -------------------------------------------------------- probation --
    def _probation(self, baseline: float, hits0: int, total0: int) -> bool:
        """Watch the auditor for ``probation_s``; True = the new epoch
        survives, False = roll back.  Judged on post-swap rows only;
        windows that never reach ``min_audit_rows`` pass (no evidence
        of regression is not evidence of regression)."""
        if self.auditor is None:
            return True
        deadline = time.monotonic() + self.cfg.probation_s
        while not self._stop.is_set():
            hits, total = self.auditor.snapshot()
            rows = total - total0
            if rows >= self.cfg.min_audit_rows:
                recall = (hits - hits0) / rows
                ctx = faults.fire(faults.REFRESH_PROBATION,
                                  recall=recall, rows=rows)
                recall = float(ctx["recall"])
                if (np.isfinite(baseline)
                        and recall < baseline - self.cfg.rollback_delta):
                    obs.event("refresh_probation_fail", recall=recall,
                              baseline=baseline, rows=rows)
                    return False
                return True
            if time.monotonic() >= deadline:
                return True
            self._stop.wait(self.cfg.probation_poll_s)
        return True

    # ------------------------------------------------------------ cycle --
    def refresh_once(self) -> str:
        """One full cycle: refit -> guarded swap -> probation.  Returns
        ``"swapped"``, ``"rolled_back"``, or ``"failed"``.  Never raises:
        a failure leaves the engine serving what it already served."""
        self._c_total.inc()
        span = obs.start_span("index_refresh")
        try:
            candidate, cand_recall = self._refit()
            ctx = faults.fire(faults.REFRESH_BUILT, index=candidate,
                              recall=cand_recall)
            candidate = ctx["index"]
            self._g_recall.set(cand_recall)
            prev_index = self.engine.index
            if self.auditor is not None:
                hits0, total0 = self.auditor.snapshot()
            else:
                hits0 = total0 = 0
            baseline = hits0 / total0 if total0 else float("nan")
            epoch = self.engine.swap_index(candidate, warm=self.cfg.warm)
            self._g_epoch.set(epoch)
            if self._probation(baseline, hits0, total0):
                self.n_refreshes += 1
                self.n_failures = 0
                self.last_error = None
                self._c_swapped.inc()
                span.end("ok", outcome="swapped", epoch=epoch,
                         recall=cand_recall)
                return "swapped"
            # ------------------------------------------------ rollback --
            back = self.engine.swap_index(prev_index, warm=self.cfg.warm)
            self._g_epoch.set(back)
            self.n_rollbacks += 1
            self.n_failures = 0
            self.last_error = None
            self._c_rollback.inc()
            obs.event("refresh_rollback", from_epoch=epoch, to_epoch=back)
            # the training stream followed a bad gradient — restart it
            # from the restored serving hyperplanes next cycle
            self._state = None
            span.end("ok", outcome="rolled_back", epoch=back)
            return "rolled_back"
        except Exception as exc:
            self.n_failures += 1
            self.n_failed += 1
            self.last_error = repr(exc)
            self._c_failures.inc()
            obs.event("refresh_failed", error=type(exc).__name__,
                      consecutive=self.n_failures)
            span.end_from_exc(exc)
            return "failed"

    # ------------------------------------------------------------- loop --
    def _backoff(self) -> float:
        return min(self.cfg.backoff_base_s * 2 ** (self.n_failures - 1),
                   self.cfg.backoff_max_s)

    def _run(self) -> None:
        while not self._stop.is_set():
            outcome = self.refresh_once()
            if outcome == "failed":
                if self.n_failures >= self.cfg.max_failures:
                    self.parked = True
                    obs.event("refresh_parked",
                              failures=self.n_failures)
                    return          # serve the last good index forever
                self._stop.wait(self._backoff())
            else:
                self._stop.wait(self.cfg.interval_s)

    def start(self) -> "IndexRefresher":
        """Start the background loop (daemon thread; idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self.parked = False
            self._thread = threading.Thread(
                target=self._run, name="index-refresher", daemon=True)
            self._thread.start()
        return self

    def close(self, timeout: float = 30.0) -> None:
        """Stop the loop; an in-progress cycle finishes its swap or
        rollback first (a half-applied swap is never left behind)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def __enter__(self) -> "IndexRefresher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
