"""Bounded, thread-safe admission queue with block | shed policies
(counterpart of ``repro.serve.runtime.queue``, the same code).

Pure queueing logic — no torch, no engine types — so backpressure semantics
are unit-testable in isolation (mirroring ``serve.batcher``'s design).

Policies when the queue is at capacity:

  * ``block`` — ``put`` waits for space (optionally up to a timeout);
    this pushes backpressure into the *producer* (closed-loop clients,
    or an RPC layer that translates the wait into flow control).
  * ``shed``  — ``put`` returns False immediately; the caller fails the
    request's future with :class:`QueueFullError`.  Open-loop traffic
    (the load harness, real user fan-in) must shed, not block, or the
    queue simply moves into the client.

``take(max_n)`` is the dispatcher side: block for the first item, then
greedily drain up to ``max_n`` — exactly the micro-batcher's coalescing
contract ("whatever is waiting, capped at the max bucket").
"""

from __future__ import annotations

import threading
from typing import Any

__all__ = ["AdmissionQueue", "POLICIES"]

POLICIES = ("block", "shed")


class AdmissionQueue:
    """FIFO with a hard depth bound and a full-queue policy."""

    def __init__(self, maxsize: int = 1024, policy: str = "block"):
        if maxsize <= 0:
            raise ValueError(f"maxsize must be positive, got {maxsize}")
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        self.maxsize = maxsize
        self.policy = policy
        self._items: list[Any] = []
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    # ---------------------------------------------------------- producer --
    def put(self, item: Any, timeout: float | None = None) -> bool:
        """Admit one item.  True on admission; False when shed (queue full
        under ``shed``, wait timed out under ``block``, or queue closed)."""
        with self._lock:
            if self._closed:
                return False
            if len(self._items) >= self.maxsize:
                if self.policy == "shed":
                    return False
                if not self._not_full.wait_for(
                        lambda: self._closed
                        or len(self._items) < self.maxsize,
                        timeout=timeout):
                    return False                      # timed out
                if self._closed:
                    return False
            self._items.append(item)
            self._not_empty.notify()
            return True

    # -------------------------------------------------------- dispatcher --
    def take(self, max_n: int, timeout: float | None = None) -> list[Any]:
        """Block (up to ``timeout``) for at least one item, then drain up
        to ``max_n`` in FIFO order.  Empty list on timeout or close."""
        with self._lock:
            if not self._not_empty.wait_for(
                    lambda: self._items or self._closed, timeout=timeout):
                return []
            got = self._items[:max_n]
            del self._items[:max_n]
            if got:
                self._not_full.notify(len(got))
            return got

    # ------------------------------------------------------------ closing --
    def close(self) -> list[Any]:
        """Refuse further admissions; wake every waiter; return whatever
        was still queued (the runtime fails those futures)."""
        with self._lock:
            self._closed = True
            leftover, self._items = self._items, []
            self._not_empty.notify_all()
            self._not_full.notify_all()
            return leftover
