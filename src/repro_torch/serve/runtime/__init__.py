"""Async serving runtime: admission queue + futures + overlapped
host/device pipeline over a (thread-safe) :class:`~repro_torch.serve.Engine`
(counterpart of ``repro.serve.runtime``: the rank request kind and the
decode kind, over a ``DecodeScheduler``).

  * ``future``  — :class:`RankFuture` and the shed-exception hierarchy.
  * ``queue``   — :class:`AdmissionQueue` (bounded, block | shed).
  * ``runtime`` — :class:`AsyncRuntime` (dispatcher + completion threads,
    deadline shedding, drain/close, :class:`RuntimeStats`).

Invariants the pieces rely on:

* **One mutator per structure.** The dispatcher thread is the only
  thread that pops the admission queue and launches device work; the
  completion thread only resolves futures.  Anything both touch (stats
  windows, future state) is lock-guarded; nothing here mutates Engine
  internals outside ``Engine.lock``.
* **Snapshots are copies.** Work captured at dispatch time (request
  batches) is materialised as a new list, never a live reference.
* **Shedding happens outside device code.** Deadlines are checked at
  admission and again at dispatch; once a batch is launched it runs to
  completion (there is no device-side cancellation), so a shed is
  always a cheap host-side future resolution.
"""

from repro_torch.serve.runtime.future import (DeadlineExceededError,
                                              QueueFullError, RankFuture,
                                              RuntimeClosedError, ShedError)
from repro_torch.serve.runtime.queue import POLICIES, AdmissionQueue
from repro_torch.serve.runtime.runtime import (AsyncRuntime, RuntimeStats,
                                               submit_decode_open_loop,
                                               submit_open_loop)

__all__ = [
    "AsyncRuntime", "RuntimeStats", "RankFuture",
    "AdmissionQueue", "POLICIES", "submit_open_loop",
    "submit_decode_open_loop",
    "ShedError", "QueueFullError", "DeadlineExceededError",
    "RuntimeClosedError",
]
