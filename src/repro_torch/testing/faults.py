"""Deterministic fault-injection harness (counterpart of
``repro.testing.faults``; the same points, actions and counts).

Production code declares *hook points* — named places where a failure
mode is worth rehearsing — by calling :func:`fire`.  Unarmed, a hook
point is one dict lookup (no locks, no logging, no torch); tests arm a
point with an *action* and the next ``fire`` executes it:

  * an ``Exception`` instance or class  -> raised at the hook point
    (fail-the-refit, leader-crash-during-OP_SWAP),
  * a ``float``/``int``                 -> ``time.sleep`` that long
    (slow-the-refit),
  * a callable ``fn(ctx: dict)``        -> run with the hook's context;
    it may raise, sleep, or MUTATE ``ctx`` to override values the
    caller reads back (corrupt-recall overrides ``ctx["recall"]``).

Actions are consumed deterministically: ``arm`` leaves the action in
place until :func:`disarm`/:func:`reset`; ``arm(..., times=n)`` auto
disarms after n fires.  ``fire_count`` exposes how often a point
fired while the harness was active (any point armed) so tests can
assert a path was actually taken.

The canonical points (names are plain strings; constants below keep
tests and docs honest):

  ``refresh.refit``          before the background refit computes
  ``refresh.built``          after the candidate index is built
  ``refresh.probation``      each probation poll (ctx: recall, rows)
  ``engine.swap``            inside the swap critical section
  ``multihost.swap_commit``  between the OP_SWAP_INDEX payload and the
                             commit flag broadcast (leader crash window)
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any

__all__ = ["arm", "disarm", "reset", "fire", "armed", "fire_count",
           "injected", "REFRESH_REFIT", "REFRESH_BUILT",
           "REFRESH_PROBATION", "ENGINE_SWAP", "MULTIHOST_SWAP_COMMIT"]

REFRESH_REFIT = "refresh.refit"
REFRESH_BUILT = "refresh.built"
REFRESH_PROBATION = "refresh.probation"
ENGINE_SWAP = "engine.swap"
MULTIHOST_SWAP_COMMIT = "multihost.swap_commit"

_mu = threading.Lock()
_armed: dict[str, tuple[Any, int | None]] = {}   # point -> (action, left)
_counts: dict[str, int] = {}


def arm(point: str, action, *, times: int | None = None) -> None:
    """Arm ``point`` with ``action`` (exception | seconds | callable).
    ``times`` bounds how many fires consume it (None = until disarm)."""
    with _mu:
        _armed[point] = (action, times)


def disarm(point: str) -> None:
    with _mu:
        _armed.pop(point, None)


def reset() -> None:
    """Disarm every point and zero the fire counters (test teardown)."""
    with _mu:
        _armed.clear()
        _counts.clear()


def armed(point: str) -> bool:
    with _mu:
        return point in _armed


def fire_count(point: str) -> int:
    with _mu:
        return _counts.get(point, 0)


@contextlib.contextmanager
def injected(point: str, action, *, times: int | None = None):
    """Scope an armed action to a ``with`` block (always disarms)."""
    arm(point, action, times=times)
    try:
        yield
    finally:
        disarm(point)


def fire(point: str, **ctx) -> dict:
    """Execute ``point``'s armed action (if any) and return the context
    dict — possibly mutated by a callable action.  Never blocks or
    raises unless a test armed it to."""
    if not _armed:                       # production fast path: one read
        return ctx
    with _mu:
        _counts[point] = _counts.get(point, 0) + 1
        entry = _armed.get(point)
        if entry is None:
            return ctx
        action, left = entry
        if left is not None:
            left -= 1
            if left <= 0:
                del _armed[point]
            else:
                _armed[point] = (action, left)
    if isinstance(action, BaseException) or (
            isinstance(action, type) and issubclass(action, BaseException)):
        raise action
    if isinstance(action, (int, float)):
        time.sleep(float(action))
        return ctx
    action(ctx)
    return ctx
