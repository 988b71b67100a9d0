"""AsyncRuntime: the thread/queue front-end over a synchronous Engine
(counterpart of ``repro.serve.runtime.runtime``).

The Engine is a *library* — ``submit``/``flush`` block the caller, so
host-side batching, padding, and device execution serialize.  The
runtime turns it into a *service*:

::

    producers --submit()--> AdmissionQueue --take(<=max_bucket)--+
      (futures back)            (block|shed, deadlines)          |
                                                        dispatcher thread
                                                 stack+pad chunk k+1 (host)
                                                 replay chunk k    (device)
                                              copy outputs to pinned host
                                                     + record an event
                                                           |
                                              bounded completion queue
                                                           |
                                                   completion thread
                                          wait on the chunk's event ->
                                          resolve futures, record metrics

Two properties fall out of the structure:

  * **Pipelining** — a step's replay and its copies to pinned host
    buffers are asynchronous, so the dispatcher hands a chunk to the
    device and immediately starts stacking/padding the next one while
    the device executes; the completion thread waits on each chunk's own
    ``torch.cuda.Event`` — never ``torch.cuda.synchronize()`` or a plain
    ``.cpu()``, which would wait for the chunks queued after it too.
    The completion queue is bounded (``PIPELINE_DEPTH``), which is the
    backpressure that stops the dispatcher racing unboundedly ahead.
  * **Determinism** — chunks go through the SAME (head, bucket) steps
    as ``Engine.flush`` and every head op is row-parallel, so a
    request's result is bit-identical to the synchronous path no matter
    how traffic was coalesced.

Admission control: bounded queue depth with ``block`` | ``shed``
policies, per-request deadlines (already-late work is shed at dispatch
time, not executed), graceful ``drain()``/``close()``.  ``stats()``
reports queue depth, shed counts (capacity vs deadline, separately),
batch occupancy, and latency percentiles that INCLUDE queue wait — the
number a client actually experiences, not just device wall time.

Streaming decode is the runtime's SECOND request kind: construct with a
``DecodeScheduler`` (see ``repro_torch.serve.decode``) and
``submit_decode`` returns a per-token :class:`TokenStream` future.
Decode sessions go through the SAME admission queue — block|shed
backpressure and per-request deadlines apply exactly as for scoring —
and the dispatcher ticks the scheduler between rank chunks, so one
runtime serves scoring traffic and many concurrent decode streams off
one engine.  ``stats()`` grows per-token latency: time-to-first-token
and inter-token p50/p95/p99, plus decode-slot occupancy.
"""

from __future__ import annotations

import math
import queue as _queue
import threading
import time
from typing import Any, NamedTuple

import numpy as np

from repro_torch import obs
from repro_torch.device import HostOutput
from repro_torch.kernels.registry import dispatch_log
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.engine import (Engine, RankResult, host_numpy,
                                      stack_rows)
from repro_torch.serve.runtime.future import (DeadlineExceededError,
                                              QueueFullError, RankFuture,
                                              RuntimeClosedError)
from repro_torch.serve.runtime.queue import POLICIES, AdmissionQueue
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["AsyncRuntime", "RuntimeStats", "submit_open_loop",
           "submit_decode_open_loop"]

_SENTINEL = object()
# device chunks in flight past the dispatcher: the next chunk is stacked
# and padded on the host while the device runs the one before
PIPELINE_DEPTH = 2


class RuntimeStats(NamedTuple):
    """Point-in-time snapshot of the runtime's serving behaviour.

    Shed accounting is split by CAUSE: ``n_shed_queue`` (capacity — the
    admission queue refused the request) vs ``n_shed_deadline`` (the
    request was admitted but already late when the dispatcher reached
    it).  Both cover scoring requests and decode sessions.  The
    ``n_decode_*`` / ``ttft_*`` / ``itl_*`` fields are zero/nan unless
    the runtime was built with a :class:`DecodeScheduler`.

    Scope note: ``n_decode_sessions``/``n_decode_done`` count THIS
    runtime's admissions, while the token/latency/occupancy decode
    fields snapshot the attached scheduler's whole stats window — if
    another producer (a concurrent blocking ``generate()``) shares the
    scheduler, its traffic is included there; call
    ``scheduler.reset_stats()`` between measured segments.
    """

    n_submitted: int             # futures handed out (incl. shed)
    n_completed: int             # resolved with a RankResult
    n_shed_queue: int            # capacity shed: refused at admission
    n_shed_deadline: int         # deadline shed: dropped at dispatch
    queue_depth: int             # waiting right now
    n_batches: int               # device chunks dispatched
    avg_batch_occupancy: float   # mean fill fraction of dispatched buckets
    latency_p50_ms: float        # submit -> resolve, queue wait INCLUDED
    latency_p95_ms: float
    latency_p99_ms: float
    device_ms_per_batch: float   # mean non-overlapping device wall/chunk
    wall_s: float                # first submit -> last completion
    throughput_rps: float        # n_completed / wall_s
    # ------------------------------------------------- streaming decode --
    n_decode_sessions: int = 0   # decode sessions submitted (incl. shed)
    n_decode_done: int = 0       # sessions that reached a terminal state
    n_decode_tokens: int = 0     # tokens streamed across all sessions
    ttft_p50_ms: float = math.nan   # submit -> first token (queue incl.)
    ttft_p95_ms: float = math.nan
    ttft_p99_ms: float = math.nan
    itl_p50_ms: float = math.nan    # inter-token latency
    itl_p95_ms: float = math.nan
    itl_p99_ms: float = math.nan
    decode_slot_occupancy: float = 0.0   # mean active/max_streams per step
    decode_tokens_per_s: float = 0.0
    n_prefill_skipped: int = 0      # full-prompt prefix-cache hits
    n_prefill_compiles: int = 0     # prefill builds (one per bucket)
    n_prefill_buckets: int = 0      # distinct power-of-two buckets
    prefix_hit_rate: float = math.nan   # shared / shareable prompt pages
    kv_pages_in_use: int = 0        # paged KV layout: live pages
    kv_peak_pages: int = 0          # paged KV layout: high-water mark


def _paced_submit(n: int, qps: float, seed: int, submit
                  ) -> tuple[list, np.ndarray]:
    """The open-loop pacer both load shapes share: draw Poisson arrival
    offsets for offered rate ``qps`` (``qps <= 0`` = burst, everything at
    t=0), sleep to each offset, call ``submit(i)`` — and never wait for
    results, so queueing delay stays visible instead of being hidden by a
    closed loop."""
    rng = np.random.default_rng(seed)
    arrivals = (np.zeros(n) if qps <= 0
                else np.cumsum(rng.exponential(1.0 / qps, n)))
    t0 = time.perf_counter()
    out = []
    for i in range(n):
        dt = (t0 + arrivals[i]) - time.perf_counter()
        if dt > 0:
            time.sleep(dt)
        out.append(submit(i))
    return out, arrivals


def submit_open_loop(runtime: "AsyncRuntime", xs, qps: float, *,
                     seed: int = 0, labels=None
                     ) -> tuple[list[RankFuture], np.ndarray]:
    """Open-loop scoring load: submit ``xs[i]`` at Poisson arrival times
    for offered rate ``qps``.  Returns (futures, arrival offsets in
    seconds)."""
    return _paced_submit(
        len(xs), qps, seed,
        lambda i: runtime.submit(xs[i],
                                 None if labels is None else labels[i]))


def submit_decode_open_loop(runtime: "AsyncRuntime", prompts, qps: float, *,
                            max_new_tokens: int, seed: int = 0,
                            eos_id: int | None = None
                            ) -> tuple[list, np.ndarray]:
    """Open-loop decode load: start session i (``prompts[i]``, a 1-D
    token row) at Poisson arrival times for offered SESSION rate ``qps``
    (``qps <= 0`` = burst).  Returns (TokenStreams, arrival offsets)."""
    return _paced_submit(
        len(prompts), qps, seed,
        lambda i: runtime.submit_decode(prompts[i],
                                        max_new_tokens=max_new_tokens,
                                        eos_id=eos_id))


class _Work(NamedTuple):
    future: RankFuture
    x: Any                       # request pytree (no batch dim, numpy)
    labels: np.ndarray | None


class _DecodeWork(NamedTuple):
    session: Any                 # DecodeSession awaiting scheduler admission


class AsyncRuntime:
    """Admission queue + futures + overlapped host/device pipeline.

    Args:
      engine: the (thread-safe) Engine to serve through.  The runtime
        shares its (head, bucket) step table and metrics window.
      head: head kind override; None uses ``engine.default_head``.
      max_queue: admission queue depth bound.
      policy: ``block`` | ``shed`` when the queue is full (see
        ``runtime.queue``).
      default_deadline_s: per-request deadline applied when ``submit``
        does not pass one; None = no deadline.
      scheduler: a ``repro_torch.serve.decode.DecodeScheduler`` enabling
        the decode request kind (``submit_decode``); the dispatcher ticks
        it between rank chunks.  Other producers may share it (a
        blocking ``generate()``: ticks serialise).
      start: spawn the worker threads now; ``start=False`` lets tests
        and callers stage a backlog first (``start()`` later).
    """

    def __init__(self, engine: Engine, *, head: str | None = None,
                 max_queue: int = 1024, policy: str = "block",
                 default_deadline_s: float | None = None,
                 scheduler=None, start: bool = True,
                 close_timeout_s: float | None = None):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        self.engine = engine
        self.head = head or engine.default_head
        self.policy = policy
        self.scheduler = scheduler
        if scheduler is not None:
            if scheduler.on_session_done is not None:
                raise ValueError(
                    "scheduler is already attached to another "
                    "AsyncRuntime — close() that runtime first (it "
                    "detaches on close); silently re-attaching would "
                    "break the first runtime's decode accounting")
            scheduler.on_session_done = self._on_decode_done
        self.default_deadline_s = default_deadline_s
        # bound for the ``with``-exit close(): an unbounded drain on a
        # wedged dispatcher would block __exit__ forever
        self.close_timeout_s = close_timeout_s
        self._q = AdmissionQueue(max_queue, policy)
        self._done_q: _queue.Queue = _queue.Queue(maxsize=PIPELINE_DEPTH)
        self._stop = threading.Event()
        self._closed = False
        self._started = False
        self._threads: list[threading.Thread] = []
        self._worker_exc: BaseException | None = None
        # stats (guarded by _mu; _drained signals pending == 0)
        self._mu = threading.Lock()
        self._drained = threading.Condition(self._mu)
        self._next_rid = 0
        self._n_submitted = 0
        self._n_admitted = 0
        self._n_completed = 0
        self._n_shed_queue = 0
        self._n_shed_deadline = 0
        self._n_failed = 0
        self._n_decode_submitted = 0
        self._n_decode_admitted = 0
        self._n_decode_done = 0
        self._n_decode_shed_deadline = 0
        self._n_batches = 0
        self._occupancy_sum = 0.0
        self.obs = obs.MetricsRegistry(scope_prefix="runtime")
        self._h_lat = self.obs.histogram(
            "runtime_request_latency_seconds",
            "submit -> resolve, queue wait included")
        self._h_device = self.obs.histogram(
            "runtime_device_seconds_per_batch",
            "non-overlapping device wall per dispatched chunk")
        self.obs.collect(self._collect_gauges)
        self._t_first: float | None = None
        self._t_last: float | None = None
        if start:
            self.start()

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "AsyncRuntime":
        if self._started:
            return self
        self._started = True
        self._threads = [
            threading.Thread(target=self._dispatch_loop,
                             name="repro-runtime-dispatch", daemon=True),
            threading.Thread(target=self._completion_loop,
                             name="repro-runtime-complete", daemon=True),
        ]
        for t in self._threads:
            t.start()
        return self

    def __enter__(self) -> "AsyncRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(self.close_timeout_s)

    # -------------------------------------------------------------- pending
    def _pending(self) -> int:
        # deadline-shed decode sessions are already inside _n_decode_done
        # (the session-done hook counts every terminal state), so only
        # the RANK portion of the deadline sheds offsets _n_admitted here
        return (self._n_admitted - self._n_completed
                - (self._n_shed_deadline - self._n_decode_shed_deadline)
                - self._n_failed
                + self._n_decode_admitted - self._n_decode_done)

    def drain(self, timeout: float | None = None) -> None:
        """Block until every admitted request has been resolved."""
        if not self._started:
            with self._mu:
                if self._pending() == 0:
                    return
            raise RuntimeError(
                "drain() on a never-started runtime with an admitted "
                "backlog: no worker will ever resolve it — call start()")
        with self._drained:
            if not self._drained.wait_for(
                    lambda: self._pending() == 0
                    or self._worker_exc is not None,
                    timeout=timeout):
                raise TimeoutError(
                    f"drain: {self._pending()} requests still pending "
                    f"after {timeout}s")
        if self._worker_exc is not None:
            raise RuntimeError("runtime worker died") from self._worker_exc

    def close(self, timeout: float | None = None) -> None:
        """Graceful shutdown: stop admitting, drain in-flight work, stop
        the worker threads.  A drain timeout still stops the runtime —
        the TimeoutError propagates, but the workers are shut down and
        whatever was still queued is failed with
        :class:`RuntimeClosedError` (never-started runtimes included)."""
        with self._mu:
            if self._closed:
                return
            self._closed = True                 # submit() now refuses
        try:
            if self._started and self._worker_exc is None:
                self.drain(timeout)
        finally:
            self._stop.set()
            exc = RuntimeClosedError("runtime closed")
            for w in self._q.close():           # undrained leftovers
                self._fail_admitted(w, exc)
            if self.scheduler is not None:      # admitted, not yet joined
                self._count_decode_failed(self.scheduler.fail_pending(
                    exc, only=lambda s: s.owner is self))
            for t in self._threads:
                t.join(timeout=5.0)
            if (self.scheduler is not None
                    and self.scheduler.on_session_done
                    == self._on_decode_done):
                self.scheduler.on_session_done = None   # detach the hook

    # --------------------------------------------------------------- submit
    def submit(self, x, labels=None, *, deadline_s: float | None = None,
               timeout: float | None = None) -> RankFuture:
        """Admit one request (leaves WITHOUT the batch dim); returns its
        future.  A full queue blocks (``block``) or fails the future with
        :class:`QueueFullError` (``shed``); ``deadline_s`` is relative to
        now and already-late work is shed at dispatch time."""
        t_sub = time.perf_counter()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        deadline = None if deadline_s is None else t_sub + deadline_s
        with self._mu:
            rid = self._next_rid
            self._next_rid += 1
            self._n_submitted += 1
            if self._t_first is None:
                self._t_first = t_sub
        fut = RankFuture(rid, t_sub, deadline)
        # the span closes wherever the future resolves (set_result /
        # set_exception), so every shed/fault path closes it for free
        fut.span = obs.start_span("request", rid=rid, head=self.head)
        if self._closed:
            fut.set_exception(RuntimeClosedError("runtime closed"))
            with self._mu:
                self._n_shed_queue += 1
            return fut
        work = _Work(fut, tree_map(host_numpy, x),
                     None if labels is None
                     else np.atleast_1d(np.asarray(host_numpy(labels),
                                                   np.int32)))
        # count the admission BEFORE the put: once the work is in the
        # queue it can complete (and notify drain()) at any moment, and
        # drain() must never observe completed > admitted
        with self._mu:
            self._n_admitted += 1
        if not self._q.put(work, timeout=timeout):
            with self._drained:
                self._n_admitted -= 1
                self._n_shed_queue += 1
                self._drained.notify_all()
            # a put can also fail because close() raced us and shut the
            # queue — report that as closed, not as transient overload
            fut.set_exception(
                RuntimeClosedError("runtime closed") if self._closed
                else QueueFullError(
                    f"queue full (depth bound {self._q.maxsize}, "
                    f"policy {self.policy})"))
        return fut

    def submit_batch(self, xb, labels=None, **kw) -> list[RankFuture]:
        """Admit every row of a batched pytree."""
        xb = tree_map(host_numpy, xb)
        n = tree_leaves(xb)[0].shape[0]
        lab = None if labels is None else host_numpy(labels)
        return [self.submit(tree_map(lambda leaf: leaf[i], xb),
                            None if lab is None else lab[i], **kw)
                for i in range(n)]

    # ------------------------------------------------------- decode submit
    def submit_decode(self, prompt, *, max_new_tokens: int,
                      eos_id: int | None = None,
                      deadline_s: float | None = None,
                      timeout: float | None = None):
        """Admit one decode session (1-D prompt tokens); returns its
        :class:`~repro_torch.serve.decode.TokenStream`, which resolves
        token by token as the scheduler interleaves the session with
        every other in-flight stream.  Admission control matches
        ``submit``: a full queue blocks or fails the stream with
        :class:`QueueFullError`, and a ``deadline_s`` that expires before
        the session reaches a pool slot sheds it with
        :class:`DeadlineExceededError` (once streaming, a session runs to
        completion)."""
        if self.scheduler is None:
            raise RuntimeError(
                "this runtime has no DecodeScheduler: pass scheduler= "
                "at construction to enable the decode request kind")
        t_sub = time.perf_counter()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        deadline = None if deadline_s is None else t_sub + deadline_s
        session = self.scheduler.make_session(
            prompt, max_new_tokens, eos_id=eos_id, t_submit=t_sub,
            deadline=deadline)
        session.owner = self
        # closes in TokenStream.finish/fail — every terminal decode path
        session.stream.span = obs.start_span(
            "decode_session", sid=session.sid,
            prompt_len=int(session.prompt.shape[0]),
            max_new_tokens=max_new_tokens)
        # until the scheduler takes it for a slot, before its prefill
        session.stream.queue_span = obs.start_span(
            "queue", parent=session.stream.span, sid=session.sid)
        with self._mu:
            self._n_decode_submitted += 1
            if self._t_first is None:
                self._t_first = t_sub
        if self._closed:
            session.stream.fail(RuntimeClosedError("runtime closed"))
            with self._mu:
                self._n_shed_queue += 1
            return session.stream
        with self._mu:
            self._n_decode_admitted += 1
        if not self._q.put(_DecodeWork(session), timeout=timeout):
            with self._drained:
                self._n_decode_admitted -= 1
                self._n_shed_queue += 1
                self._drained.notify_all()
            session.stream.fail(
                RuntimeClosedError("runtime closed") if self._closed
                else QueueFullError(
                    f"queue full (depth bound {self._q.maxsize}, "
                    f"policy {self.policy})"))
        return session.stream

    def _on_decode_done(self, session, reason: str) -> None:
        """Scheduler hook: a session reached a terminal state (finished,
        or shed at slot-join time).  Sessions another producer submitted
        to the shared scheduler (e.g. a concurrent blocking generate())
        are not this runtime's accounting problem."""
        if session.owner is not self:
            return
        with self._drained:
            self._n_decode_done += 1
            if reason == "shed_deadline":
                self._n_shed_deadline += 1
                self._n_decode_shed_deadline += 1
            self._drained.notify_all()

    # ------------------------------------------------------------ dispatcher
    def _sched_busy(self) -> bool:
        return self.scheduler is not None and not self.scheduler.idle

    def _route_decode(self, works: list) -> list:
        """Hand decode sessions to the scheduler; return the rank works."""
        if self.scheduler is None:
            return works
        for w in works:
            if isinstance(w, _DecodeWork):
                self.scheduler.add_session(w.session)
        return [w for w in works if not isinstance(w, _DecodeWork)]

    def _dispatch_loop(self) -> None:
        try:
            batcher = self.engine.batcher
            while not (self._stop.is_set() and len(self._q) == 0
                       and not self._sched_busy()):
                # an active decode pipeline paces the loop itself (a tick
                # waits on the lagged step), so don't linger on the
                # queue; decode sessions route to the scheduler as soon
                # as they are taken
                works = self._route_decode(self._q.take(
                    batcher.max_bucket,
                    timeout=0.0 if self._sched_busy() else 0.05))
                if self.scheduler is not None:
                    # admit + one fused step + resolve the previous
                    # step's tokens; overlaps the rank chunk below
                    self.scheduler.tick()
                if not works:
                    continue
                live = self._shed_late(works)
                if not live:
                    continue
                span = obs.start_span("chunk", head=self.head,
                                      n=len(live))
                try:
                    # host side: stack rows and pad to the bucket in
                    # numpy — this is the work that overlaps the device
                    # executing the PREVIOUS chunk
                    bucket = batcher.bucket_for(len(live))
                    span.set(bucket=bucket)
                    for w in live:
                        w.future.span.event("dispatch", bucket=bucket)
                    padded = MicroBatcher.pad_rows(
                        stack_rows([w.x for w in live]), bucket)
                    step = self.engine._step(self.head, bucket)
                    n_disp = len(dispatch_log())
                    n_comp = self.engine.n_builds()
                    t0 = time.perf_counter()
                    # replay, then copies to pinned host buffers and an
                    # event: all asynchronous on the card
                    host = HostOutput(step(padded))
                    # kernel attribution: which registry impls this chunk
                    # dispatched, and whether it paid a (head, bucket)
                    # build (both non-empty only at a build on the card)
                    new = dispatch_log()[n_disp:]
                    d_comp = self.engine.n_builds() - n_comp
                    if new or d_comp:
                        span.set(dispatches=[f"{op}:{impl}"
                                             for op, impl in new],
                                 compile_delta=d_comp)
                except Exception as e:
                    # chunk-local failure (malformed request, build
                    # error): fail THIS chunk's futures, keep serving —
                    # one bad request must not take down the front-end
                    span.end_from_exc(e)
                    for w in live:
                        self._fail(w.future, e)
                    continue
                self._put_done((live, host, bucket, t0, span))
        except BaseException as e:              # fail loudly, not silently
            self._abort(e)
            if self.scheduler is not None:
                # this runtime will never tick again: resolve ITS
                # streams so consumers see the failure instead of
                # hanging (other producers' sessions stay alive — their
                # own run() loops still tick)
                self._count_decode_failed(self.scheduler.fail_all(
                    RuntimeError("runtime worker died"),
                    only=lambda s: s.owner is self))
                if self.scheduler.on_session_done == self._on_decode_done:
                    self.scheduler.on_session_done = None   # detach: dead
        finally:
            try:
                self._done_q.put(_SENTINEL, timeout=5.0)
            except _queue.Full:                 # completion thread dead
                pass

    def _fail_chunk(self, item) -> None:
        item[4].end("error", error="runtime worker died")
        for w in item[0]:
            self._fail(w.future, RuntimeError("runtime worker died"))

    def _put_done(self, item) -> None:
        """Hand a dispatched chunk to the completion thread; if the
        completion thread died, fail the chunk's futures instead of
        blocking forever (or stranding the chunk in the queue)."""
        while self._worker_exc is None:
            try:
                self._done_q.put(item, timeout=0.1)
                break
            except _queue.Full:
                if self._stop.is_set():
                    self._fail_chunk(item)
                    return
        # _abort sets _worker_exc BEFORE draining _done_q, so if the
        # completion thread died around our put, one of the two drains
        # (abort's, or this reclaim) is guaranteed to see the chunk
        if self._worker_exc is not None:
            while True:
                try:
                    extra = self._done_q.get_nowait()
                except _queue.Empty:
                    return
                if extra is not _SENTINEL:
                    self._fail_chunk(extra)

    def _shed_late(self, works: list[_Work]) -> list[_Work]:
        now = time.perf_counter()
        live = []
        for w in works:
            if w.future.deadline is not None and now > w.future.deadline:
                self._fail(w.future, DeadlineExceededError(
                    f"request {w.future.rid} exceeded its deadline by "
                    f"{(now - w.future.deadline) * 1e3:.1f} ms in queue"),
                    kind="deadline")
            else:
                live.append(w)
        return live

    # ------------------------------------------------------------ completion
    def _completion_loop(self) -> None:
        try:
            while True:
                item = self._done_q.get()
                if item is _SENTINEL:
                    break
                works, host, bucket, t0, span = item
                out = host.wait()               # this chunk's event only
                t1 = time.perf_counter()
                # chunks overlap under pipelining (chunk k+1 is dispatched
                # while k executes), so attribute each chunk only the wall
                # PAST the previous chunk's completion — the summed walls
                # then add up to pipeline busy time instead of ~2x it
                prev = self._t_last
                wall = t1 - (t0 if prev is None else max(t0, prev))
                n = len(works)
                lats = [t1 - w.future.t_submit for w in works]
                labels = Engine._stack_labels([w.labels for w in works])
                self.engine._record(out, n, wall, lats, labels)
                aud = self.engine.auditor
                if aud is not None and self.head != "full":
                    # thunk: the unpadded re-stack is only paid when the
                    # auditor's coin flip samples this chunk
                    aud.offer(lambda ws=works: stack_rows(
                        [w.x for w in ws]), out.ids[:n])
                span.end("ok", wall_s=wall)
                for i, w in enumerate(works):
                    w.future.set_result(
                        RankResult(w.future.rid, out.logits[i], out.ids[i]))
                for v in lats:
                    self._h_lat.record(v)
                self._h_device.record(wall)
                with self._drained:
                    self._n_completed += n
                    self._n_batches += 1
                    self._occupancy_sum += n / bucket
                    self._t_last = t1
                    self._drained.notify_all()
        except BaseException as e:
            self._abort(e)

    # ---------------------------------------------------------------- misc
    def _fail_admitted(self, w, exc: BaseException) -> None:
        """Fail one admitted work item of either kind."""
        if isinstance(w, _DecodeWork):
            w.session.stream.fail(exc)
            self._count_decode_failed([w.session])
        else:
            self._fail(w.future, exc)

    def _count_decode_failed(self, sessions: list) -> None:
        mine = [s for s in sessions if s.owner is self]
        if not mine:
            return
        with self._drained:
            self._n_decode_done += len(mine)
            self._drained.notify_all()

    def _fail(self, fut: RankFuture, exc: BaseException,
              kind: str = "closed") -> None:
        if not fut.done():
            fut.set_exception(exc)
        with self._drained:
            if kind == "deadline":
                self._n_shed_deadline += 1
            else:
                self._n_failed += 1
            self._drained.notify_all()

    def _abort(self, exc: BaseException) -> None:
        """A worker died: record the error, fail everything still queued,
        and wake drain() so callers see the failure instead of hanging."""
        self._stop.set()
        with self._mu:
            if self._worker_exc is None:
                self._worker_exc = exc
        for w in self._q.close():
            self._fail_admitted(w, RuntimeError("runtime worker died"))
        while True:                     # unjam a blocked dispatcher put
            try:
                item = self._done_q.get_nowait()
            except _queue.Empty:
                break
            if item is not _SENTINEL:
                self._fail_chunk(item)
        with self._drained:
            self._drained.notify_all()

    def _collect_gauges(self, reg) -> None:
        """Exporter hook: refresh control-flow gauges from stats() so the
        Prometheus exposition carries them without double bookkeeping."""
        s = self.stats()
        reg.gauge("runtime_queue_depth").set(s.queue_depth)
        reg.gauge("runtime_submitted_total").set(s.n_submitted)
        reg.gauge("runtime_completed_total").set(s.n_completed)
        reg.gauge("runtime_shed_queue_total").set(s.n_shed_queue)
        reg.gauge("runtime_shed_deadline_total").set(s.n_shed_deadline)
        reg.gauge("runtime_batch_occupancy").set(s.avg_batch_occupancy)
        reg.gauge("runtime_throughput_rps").set(s.throughput_rps)
        if self.scheduler is not None:
            reg.gauge("decode_sessions_total").set(s.n_decode_sessions)
            reg.gauge("decode_tokens_total").set(s.n_decode_tokens)
            reg.gauge("decode_tokens_per_s").set(s.decode_tokens_per_s)
            reg.gauge("decode_slot_occupancy").set(s.decode_slot_occupancy)
            reg.gauge("decode_prefix_hit_rate").set(s.prefix_hit_rate)
            reg.gauge("decode_kv_pages_in_use").set(s.kv_pages_in_use)

    def stats(self) -> RuntimeStats:
        ds = None if self.scheduler is None else self.scheduler.stats()
        # quantile math runs on the histograms' own bounded reservoirs —
        # NEVER under self._mu, so a stats() poll cannot stall the
        # dispatcher/completion threads no matter the window size
        p50, p95, p99 = self._h_lat.quantile((50, 95, 99))
        device_ms = self._h_device.mean() * 1e3
        with self._mu:
            wall = ((self._t_last - self._t_first)
                    if self._t_first is not None and self._t_last is not None
                    else 0.0)
            decode = {} if ds is None else dict(
                n_decode_sessions=self._n_decode_submitted,
                n_decode_done=self._n_decode_done,
                n_decode_tokens=ds.n_tokens,
                ttft_p50_ms=ds.ttft_p50_ms, ttft_p95_ms=ds.ttft_p95_ms,
                ttft_p99_ms=ds.ttft_p99_ms,
                itl_p50_ms=ds.itl_p50_ms, itl_p95_ms=ds.itl_p95_ms,
                itl_p99_ms=ds.itl_p99_ms,
                decode_slot_occupancy=ds.slot_occupancy,
                decode_tokens_per_s=ds.tokens_per_s,
                n_prefill_skipped=ds.n_prefill_skipped,
                n_prefill_compiles=ds.n_prefill_compiles,
                n_prefill_buckets=ds.n_prefill_buckets,
                prefix_hit_rate=ds.prefix_hit_rate,
                kv_pages_in_use=ds.kv_pages_in_use,
                kv_peak_pages=ds.kv_peak_pages,
            )
            return RuntimeStats(
                **decode,
                n_submitted=self._n_submitted,
                n_completed=self._n_completed,
                n_shed_queue=self._n_shed_queue,
                n_shed_deadline=self._n_shed_deadline,
                queue_depth=len(self._q),
                n_batches=self._n_batches,
                avg_batch_occupancy=(self._occupancy_sum
                                     / max(self._n_batches, 1)),
                latency_p50_ms=p50 * 1e3,
                latency_p95_ms=p95 * 1e3,
                latency_p99_ms=p99 * 1e3,
                device_ms_per_batch=device_ms,
                wall_s=wall,
                throughput_rps=(self._n_completed / wall if wall > 0
                                else 0.0),
            )
