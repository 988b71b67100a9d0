"""Per-request futures and the admission-failure exception hierarchy
(counterpart of ``repro.serve.runtime.future``, the same code).

A :class:`RankFuture` is what :meth:`AsyncRuntime.submit` hands back for
every request — a minimal, dependency-free future (one Event + a slot)
rather than ``concurrent.futures.Future`` so the runtime controls the
exact resolution semantics:

  * resolved exactly once, from the completion path (or the shed path),
  * ``result()`` re-raises the shed reason (:class:`QueueFullError`,
    :class:`DeadlineExceededError`, :class:`RuntimeClosedError`) so
    callers handle admission failures and successes through one object.

Timing metadata (``t_submit``, ``deadline``) lives on the future so the
dispatcher can shed already-late work without a side table.
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING

if TYPE_CHECKING:                                   # pragma: no cover
    from repro_torch.serve.engine import RankResult

__all__ = ["RankFuture", "ShedError", "QueueFullError",
           "DeadlineExceededError", "RuntimeClosedError"]


class ShedError(RuntimeError):
    """Base: the runtime refused or abandoned a request (admission
    control), as opposed to the head itself failing."""


class QueueFullError(ShedError):
    """Admission queue at capacity under the ``shed`` policy (or a
    ``block``-policy wait timed out)."""


class DeadlineExceededError(ShedError):
    """The request's deadline passed while it sat in the queue; the
    dispatcher dropped it instead of wasting device time on late work."""


class RuntimeClosedError(ShedError):
    """Submitted to (or still queued in) a runtime that was closed."""


class RankFuture:
    """Write-once future for one submitted request."""

    __slots__ = ("rid", "t_submit", "deadline", "t_done", "span",
                 "_done", "_result", "_exc")

    def __init__(self, rid: int, t_submit: float,
                 deadline: float | None = None):
        self.rid = rid
        self.t_submit = t_submit          # perf_counter at admission
        self.deadline = deadline          # absolute perf_counter, or None
        self.t_done: float | None = None  # perf_counter at resolution
        self.span = None                  # obs span; closed at resolution
        self._done = threading.Event()
        self._result: RankResult | None = None
        self._exc: BaseException | None = None

    # -- producer side (runtime internals) --------------------------------
    # the future is the one object every terminal path goes through, so
    # resolution is where the request's span closes — a shed, a chunk
    # fault, or a close can never leak an open span
    def set_result(self, result: "RankResult") -> None:
        assert not self._done.is_set(), f"future {self.rid} resolved twice"
        self._result = result
        self.t_done = time.perf_counter()
        self._done.set()
        if self.span is not None:
            self.span.end("ok")

    def set_exception(self, exc: BaseException) -> None:
        assert not self._done.is_set(), f"future {self.rid} resolved twice"
        self._exc = exc
        self.t_done = time.perf_counter()
        self._done.set()
        if self.span is not None:
            self.span.end_from_exc(exc)

    # -- consumer side -----------------------------------------------------
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None) -> "RankResult":
        """Block for the result; re-raises the shed reason on failure."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} not resolved "
                               f"within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: float | None = None) -> BaseException | None:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} not resolved "
                               f"within {timeout}s")
        return self._exc

    def __repr__(self) -> str:            # pragma: no cover - debug aid
        state = ("pending" if not self._done.is_set()
                 else "failed" if self._exc is not None else "done")
        return f"RankFuture(rid={self.rid}, {state})"
