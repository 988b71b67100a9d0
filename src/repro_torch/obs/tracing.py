"""Request tracing: lightweight spans threaded through the serving seams
(counterpart of ``repro.obs.tracing``).

A :class:`Span` is one timed unit of work — a scoring request's whole
submit→complete life, one dispatcher chunk, one decode session, one
prefill, one scheduler tick — carrying attributes (rid/sid, head kind,
bucket), point-in-time *events* (join, first token, KV page churn), and
a terminal *status*.  Spans are deliberately flat (no parent pointers):
the rid/sid attributes correlate a request span with the chunk/tick
spans that served it, which is all the life-of-a-request view needs and
keeps the record cheap enough for the hot path.

Terminal statuses mirror the runtime's failure taxonomy so every shed
path is distinguishable in a trace: ``ok``, ``shed_queue``,
``shed_deadline``, ``shed_kv_oom``, ``closed``, ``error``
(:func:`status_from_exc` maps the exception hierarchy by class name to
avoid importing serve modules here).

The process-wide tracer keeps the set of OPEN spans and a bounded ring
(``REPRO_OBS_TRACE_CAP`` finished spans/events, default 4096) —
sustained load cannot grow tracing memory.  :func:`assert_quiescent`
fails if any span is still open (the span-leak regression every
failure-path test runs in teardown), and :func:`trace_export` renders
the ring as a chrome://tracing / Perfetto-compatible JSON object
(``{"traceEvents": [...]}``, complete ``"X"`` events for spans, instant
``"i"`` events for point events).

The JAX package's deep hook (``maybe_jax_profile``, a ``jax.profiler``
trace around a block) has no counterpart here yet: a device timeline of
the port comes from ``torch.profiler`` around the call instead.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

__all__ = ["Span", "SPAN_STATUSES", "start_span", "event", "trace_export",
           "assert_quiescent", "open_spans", "reset_tracer",
           "status_from_exc", "TRACE_CAP_ENV"]

SPAN_STATUSES = ("ok", "shed_queue", "shed_deadline", "shed_kv_oom",
                 "closed", "error")
TRACE_CAP_ENV = "REPRO_OBS_TRACE_CAP"

_EVENTS_PER_SPAN = 64                   # bound per-span event lists too

_EXC_STATUS = {
    "QueueFullError": "shed_queue",
    "DeadlineExceededError": "shed_deadline",
    "KVPoolExhaustedError": "shed_kv_oom",
    "RuntimeClosedError": "closed",
}


def status_from_exc(exc: BaseException) -> str:
    """Terminal span status for a failure, mapped by exception class
    name (by name, not import, so serve <-> obs stays acyclic);
    subclass walks the MRO so e.g. a ShedError subtype still maps."""
    for klass in type(exc).__mro__:
        s = _EXC_STATUS.get(klass.__name__)
        if s is not None:
            return s
    return "error"


class Span:
    """One timed unit of work.  ``end()`` is idempotent — the first
    terminal status wins, matching the write-once futures that close
    request spans."""

    __slots__ = ("name", "sid", "t0", "t1", "status", "attrs", "events",
                 "tid", "_n_dropped_events")

    def __init__(self, name: str, sid: int, attrs: dict):
        self.name = name
        self.sid = sid
        self.t0 = time.perf_counter()
        self.t1: float | None = None
        self.status: str | None = None
        self.attrs = attrs
        self.events: list[tuple[str, float, dict]] = []
        self.tid = threading.get_ident()
        self._n_dropped_events = 0

    def event(self, name: str, **attrs) -> None:
        if self.t1 is not None:
            return                      # late event on a closed span: drop
        if len(self.events) >= _EVENTS_PER_SPAN:
            self._n_dropped_events += 1
            return
        self.events.append((name, time.perf_counter(), attrs))

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    @property
    def open(self) -> bool:
        return self.t1 is None

    def end(self, status: str = "ok", **attrs) -> None:
        if self.t1 is not None:
            return
        if status not in SPAN_STATUSES:
            raise ValueError(f"status must be one of {SPAN_STATUSES}, "
                             f"got {status!r}")
        if attrs:
            self.attrs.update(attrs)
        if self._n_dropped_events:
            self.attrs["dropped_events"] = self._n_dropped_events
        self.t1 = time.perf_counter()
        self.status = status
        _tracer._finish(self)

    def end_from_exc(self, exc: BaseException) -> None:
        self.end(status_from_exc(exc), error=repr(exc))

    def duration_s(self) -> float | None:
        return None if self.t1 is None else self.t1 - self.t0

    def __repr__(self) -> str:          # pragma: no cover - debug aid
        state = "open" if self.t1 is None else self.status
        return f"Span({self.name!r}, sid={self.sid}, {state})"


class _NoopSpan:
    """Shared span stand-in when observability is disabled."""

    __slots__ = ()
    name = "noop"
    sid = -1
    status = None
    attrs: dict = {}
    events: list = []
    open = False

    def event(self, name: str, **attrs) -> None:
        pass

    def set(self, **attrs) -> None:
        pass

    def end(self, status: str = "ok", **attrs) -> None:
        pass

    def end_from_exc(self, exc: BaseException) -> None:
        pass

    def duration_s(self) -> None:
        return None


NOOP_SPAN = _NoopSpan()


class _Tracer:
    def __init__(self, cap: int | None = None):
        if cap is None:
            cap = int(os.environ.get(TRACE_CAP_ENV, "4096") or 4096)
        self._mu = threading.Lock()
        self._open: dict[int, Span] = {}
        self._done: deque = deque(maxlen=cap)
        self._next_sid = 0
        self.n_started = 0
        self.n_finished = 0
        self.n_events = 0

    def start(self, name: str, attrs: dict) -> Span:
        with self._mu:
            sid = self._next_sid
            self._next_sid += 1
            self.n_started += 1
        span = Span(name, sid, attrs)
        with self._mu:
            self._open[sid] = span
        return span

    def _finish(self, span: Span) -> None:
        with self._mu:
            self._open.pop(span.sid, None)
            self._done.append(span)
            self.n_finished += 1

    def instant(self, name: str, attrs: dict) -> None:
        with self._mu:
            self._done.append((name, time.perf_counter(),
                               threading.get_ident(), attrs))
            self.n_events += 1

    def open_spans(self) -> list[Span]:
        with self._mu:
            return list(self._open.values())

    def drain(self) -> tuple[list, list[Span]]:
        with self._mu:
            return list(self._done), list(self._open.values())

    def reset(self) -> None:
        with self._mu:
            self._open.clear()
            self._done.clear()
            self.n_started = self.n_finished = self.n_events = 0


_tracer = _Tracer()


def _enabled() -> bool:
    from repro_torch import obs
    return obs.enabled()


def start_span(name: str, **attrs) -> Span | _NoopSpan:
    """Open a span (returns the shared no-op when obs is disabled, so
    call sites never branch)."""
    if not _enabled():
        return NOOP_SPAN
    return _tracer.start(name, attrs)


def event(name: str, **attrs) -> None:
    """Record a process-level instant event (KV page churn, evictions —
    things not owned by any one span)."""
    if not _enabled():
        return
    _tracer.instant(name, attrs)


def open_spans() -> list[Span]:
    return _tracer.open_spans()


def assert_quiescent() -> None:
    """Raise if any span is still open — a failure path that forgot to
    close its span.  Run this in test teardown after drain/close."""
    left = _tracer.open_spans()
    if left:
        names = ", ".join(f"{s.name}(sid={s.sid}, {s.attrs})"
                          for s in left[:8])
        raise AssertionError(
            f"{len(left)} span(s) still open after teardown: {names}")


def reset_tracer() -> None:
    _tracer.reset()


def _json_attrs(attrs: dict) -> dict:
    return {k: (v if isinstance(v, (int, float, str, bool, type(None)))
                else repr(v)) for k, v in attrs.items()}


def trace_export(path: str | None = None, *,
                 include_open: bool = True) -> dict:
    """Render the trace ring as a chrome://tracing JSON object and
    optionally write it to ``path``.  Spans become complete (``"X"``)
    events with microsecond timestamps; point events become instant
    (``"i"``) events; still-open spans (if requested) become ``"B"``
    begin events so a hung request is visible in the timeline."""
    done, open_ = _tracer.drain()
    events: list[dict] = []
    pid = os.getpid()

    def us(t: float) -> float:
        return t * 1e6

    for item in done:
        if isinstance(item, Span):
            args = dict(_json_attrs(item.attrs), status=item.status)
            events.append({"name": item.name, "ph": "X", "pid": pid,
                           "tid": item.tid, "ts": us(item.t0),
                           "dur": us(item.t1 - item.t0), "args": args})
            for ev_name, ev_t, ev_attrs in item.events:
                events.append({"name": f"{item.name}.{ev_name}", "ph": "i",
                               "pid": pid, "tid": item.tid, "ts": us(ev_t),
                               "s": "t", "args": _json_attrs(ev_attrs)})
        else:
            name, t, tid, attrs = item
            events.append({"name": name, "ph": "i", "pid": pid, "tid": tid,
                           "ts": us(t), "s": "g",
                           "args": _json_attrs(attrs)})
    if include_open:
        for s in open_:
            events.append({"name": s.name, "ph": "B", "pid": pid,
                           "tid": s.tid, "ts": us(s.t0),
                           "args": _json_attrs(s.attrs)})
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(out, f)
    return out

