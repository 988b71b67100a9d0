"""Request tracing: lightweight spans threaded through the serving seams
(counterpart of ``repro.obs.tracing``).

A :class:`Span` is one timed unit of work — a scoring request's whole
submit→complete life, one dispatcher chunk, one decode session, one
prefill, one scheduler tick — carrying attributes (rid/sid, head kind,
bucket), point-in-time *events* (join, first token), and a terminal
*status*.

Two forms:

* :func:`start_span` opens a long-lived span that may end on another
  thread (``request``, ``chunk``, ``decode_session``, ``queue``); it has
  a parent only when one is passed (``parent=``).
* :func:`span` is a ``with`` block on one thread (``rank``, ``step.*``,
  ``output.*``, ``tick``, ``tick.*``, ``prefill``, ``prefill.*``).  Its
  parent is the ``with`` span that encloses it on the thread, or the one
  passed, so a layer's self time (its span less its children) can be
  computed from the ring.  While a ``torch.profiler`` session records,
  the block is also a profiler range of the same name, so the profile's
  host ops sit inside the program's spans and a device idle gap can be
  named after the span that was open.

A parent is recorded by its ``sid``; the chrome export carries a span's
own ``sid`` as the event's ``id`` and its parent's as ``args["parent"]``.

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
``"i"`` events for point events).  Spans stamp ``time.perf_counter``;
the export gives them on that clock, or (``clock="profiler"``, as the
``/trace`` endpoint does) on ``torch.profiler``'s, the Unix epoch,
through one ``(time_ns, perf_counter_ns)`` pair read at import, so the
ring and a :func:`maybe_profile` trace overlay in Perfetto.

One optional deep hook: :func:`maybe_profile` wraps a block in a
``torch.profiler`` trace written under the directory it is given — the
counterpart of the JAX package's ``maybe_jax_profile``, between "spans
say the device step is slow" and a kernel-level timeline (chrome://tracing
/ Perfetto JSON: host ops of every thread, CUDA runtime calls, device
kernels).  The directory is an argument, not an environment variable:
every ``REPRO_*`` name in ``src/`` must have a row in ``docs/KERNELS.md``,
which predates the port.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager

__all__ = ["Span", "SPAN_STATUSES", "start_span", "span", "event",
           "trace_export", "assert_quiescent", "open_spans", "reset_tracer",
           "status_from_exc", "maybe_profile", "TRACE_CAP_ENV", "CLOCKS"]

SPAN_STATUSES = ("ok", "shed_queue", "shed_deadline", "shed_kv_oom",
                 "closed", "error")
TRACE_CAP_ENV = "REPRO_OBS_TRACE_CAP"

_EVENTS_PER_SPAN = 64                   # bound per-span event lists too

# the export's clocks: the spans' own, and torch.profiler's (Unix epoch),
# reached through one pair of readings taken together at import
CLOCKS = ("perf_counter", "profiler")
_UNIX_NS0 = time.time_ns()
_PERF_NS0 = time.perf_counter_ns()

# the span each thread's innermost ``with obs.span(...)`` block holds
_local = threading.local()

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
                 "tid", "parent", "_n_dropped_events", "_outer", "_range")

    def __init__(self, name: str, sid: int, attrs: dict,
                 parent: int | None = None):
        self.name = name
        self.sid = sid
        self.parent = parent
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

    def __enter__(self) -> "Span":
        self._outer = getattr(_local, "span", None)
        _local.span = self
        self._range = None
        if _profiling():
            self._range = _profiler_range(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, kind, exc, tb) -> bool:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _local.span = self._outer
        self._outer = None
        if exc is None:
            self.end()
        else:
            self.end_from_exc(exc)
        return False

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

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, kind, exc, tb) -> bool:
        return False

    def duration_s(self) -> None:
        return None


NOOP_SPAN = _NoopSpan()


class _Tracer:
    """The open spans and the ring of finished ones.  Every operation on
    them is one call of a builtin (``next`` of a counter, a dict store or
    pop, a deque append, a copy to a list), each atomic under the GIL, so
    the hot path takes no lock.  The ring keeps a finished span as a plain
    tuple of its fields, its attributes' keys and values as two tuples
    (``("X", name, sid, parent, t0, t1, status, keys, values, events,
    tid)``; an instant is ``("i", name, t, tid, attrs)``).  The garbage
    collector stops tracking a tuple of numbers and strings, and one of
    such tuples made after them, at its first pass over them, so a ring
    of a million spans does not lengthen its full passes."""

    def __init__(self, cap: int | None = None):
        if cap is None:
            cap = int(os.environ.get(TRACE_CAP_ENV, "4096") or 4096)
        self._open: dict[int, Span] = {}
        self._done: deque = deque(maxlen=cap)
        self._sids = itertools.count()

    def start(self, name: str, attrs: dict, parent: int | None) -> Span:
        span = Span(name, next(self._sids), attrs, parent)
        self._open[span.sid] = span
        return span

    def _finish(self, span: Span) -> None:
        # into the ring before out of the open set: an export between the
        # two sees the span in both, never in neither
        attrs = span.attrs
        self._done.append(("X", span.name, span.sid, span.parent, span.t0,
                           span.t1, span.status, tuple(attrs),
                           tuple(attrs.values()), tuple(span.events),
                           span.tid))
        self._open.pop(span.sid, None)

    def instant(self, name: str, attrs: dict) -> None:
        self._done.append(("i", name, time.perf_counter(),
                           threading.get_ident(), attrs))

    def open_spans(self) -> list[Span]:
        return list(self._open.values())

    def drain(self) -> tuple[list, list[Span]]:
        return list(self._done), list(self._open.values())

    def reset(self) -> None:
        self._open.clear()
        self._done.clear()


_tracer = _Tracer()


_obs = None


def _enabled() -> bool:
    global _obs
    if _obs is None:
        from repro_torch import obs
        _obs = obs
    return _obs._ENABLED


_torch_profiler = None


def _profiling() -> bool:
    """Is a ``torch.profiler`` session recording?  torch's own Python
    flag, set for every thread; ``torch._C._autograd._profiler_enabled()``
    reads False everywhere under ``profile_all_threads``.  (Without
    ``torch.autograd.profiler`` imported, nothing records.)"""
    global _torch_profiler
    if _torch_profiler is None:
        _torch_profiler = sys.modules.get("torch.autograd.profiler")
        if _torch_profiler is None:
            return False
    return _torch_profiler._is_profiler_enabled


_range_class = None


def _profiler_range(name: str):
    """A profiler range (``torch.profiler.record_function``'s cheap
    kind: ~1.5 us a block where ``record_function`` costs ~13)."""
    global _range_class
    if _range_class is None:
        from torch._C._profiler import _RecordFunctionFast
        _range_class = _RecordFunctionFast
    return _range_class(name)


def _sid(parent) -> int | None:
    return parent.sid if parent.__class__ is Span else None


def start_span(name: str, *, parent=None, **attrs) -> Span | _NoopSpan:
    """Open a span that the caller ends, on any thread (returns the
    shared no-op when obs is disabled, so call sites never branch).
    ``parent``, a span, is recorded as its parent."""
    if not _enabled():
        return NOOP_SPAN
    return _tracer.start(name, attrs, _sid(parent))


def span(name: str, *, parent=None, **attrs) -> Span | _NoopSpan:
    """A span for a ``with`` block on this thread::

        with obs.span("step.copy_in") as s:
            ...
            s.set(pinned=n)

    Its parent is ``parent`` (a span) if given, else the ``with`` span
    that encloses the block on this thread.  The block ends it, ``ok`` or
    with the status of the exception that leaves it.  While a
    ``torch.profiler`` session records, the block is also a profiler
    range named ``name``.  With obs off it is the shared no-op."""
    if not _enabled():
        return NOOP_SPAN
    if parent is None:
        parent = getattr(_local, "span", None)
        if parent is None:
            return _tracer.start(name, attrs, None)
    return _tracer.start(name, attrs, _sid(parent))


def event(name: str, **attrs) -> None:
    """Record a process-level instant event (KV page allocations and
    prefix hits, sheds — things not owned by any one span)."""
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


def _args(attrs: dict, parent: int | None, **extra) -> dict:
    args = _json_attrs(attrs)
    if parent is not None:
        args["parent"] = parent
    args.update(extra)
    return args


def trace_export(path: str | None = None, *, include_open: bool = True,
                 clock: str = "perf_counter") -> dict:
    """Render the trace ring as a chrome://tracing JSON object and
    optionally write it to ``path``.  Spans become complete (``"X"``)
    events with microsecond timestamps, their ``sid`` as ``id`` and
    their parent's ``sid`` as ``args["parent"]``; point events become
    instant (``"i"``) events; still-open spans (if requested) become
    ``"B"`` begin events so a hung request is visible in the timeline.
    ``clock`` is ``perf_counter`` (the spans' own: ``ts`` / 1e6 is a
    ``time.perf_counter()`` reading) or ``profiler`` (Unix-epoch
    microseconds, as ``torch.profiler``'s trace); ``otherData`` holds
    the clock and the pair of readings that links the two."""
    if clock not in CLOCKS:
        raise ValueError(f"clock must be one of {CLOCKS}, got {clock!r}")
    done, open_ = _tracer.drain()
    events: list[dict] = []
    pid = os.getpid()
    shift = (_UNIX_NS0 - _PERF_NS0) / 1e3 if clock == "profiler" else 0.0

    def us(t: float) -> float:
        return t * 1e6 + shift

    for item in done:
        if item[0] == "X":
            _, name, sid, parent, t0, t1, status, keys, values, evs, tid = \
                item
            events.append({"name": name, "ph": "X", "pid": pid, "tid": tid,
                           "id": sid, "ts": us(t0), "dur": (t1 - t0) * 1e6,
                           "args": _args(dict(zip(keys, values)), parent,
                                         status=status)})
            for ev_name, ev_t, ev_attrs in evs:
                events.append({"name": f"{name}.{ev_name}", "ph": "i",
                               "pid": pid, "tid": tid, "ts": us(ev_t),
                               "s": "t", "args": _json_attrs(ev_attrs)})
        else:
            _, name, t, tid, attrs = item
            events.append({"name": name, "ph": "i", "pid": pid, "tid": tid,
                           "ts": us(t), "s": "g",
                           "args": _json_attrs(attrs)})
    if include_open:
        for s in open_:
            events.append({"name": s.name, "ph": "B", "pid": pid,
                           "tid": s.tid, "id": s.sid, "ts": us(s.t0),
                           "args": _args(s.attrs, s.parent)})
    out = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"clock": clock, "unix_ns": _UNIX_NS0,
                         "perf_counter_ns": _PERF_NS0}}
    if path is not None:
        with open(path, "w") as f:
            json.dump(out, f)
    return out


_trace_seq = itertools.count()


@contextmanager
def maybe_profile(target: str | None = None, suffix: str = "", *,
                  device=None):
    """Trace the block with ``torch.profiler`` into a new chrome://tracing
    JSON file under ``target`` (made if missing); a free no-op, yielding
    ``None``, when ``target`` is ``None`` or observability is off.

    The activities follow ``device``: the host always, the card's too when
    ``device`` is a CUDA device (never chosen by probing for a card).
    Host ops are recorded on every thread, so the async runtime's
    dispatcher and completion threads show beside the caller's.  Each
    block writes its own file, ``<suffix>-<pid>-<n>.pt.trace.json``, as
    ``jax.profiler.trace`` writes a run directory per trace; a failure
    to write it raises.

    Yields the ``torch.profiler.profile`` object (JAX's hook yields
    nothing), so a caller can read the window's events without parsing
    the file; after the block its ``trace_path`` and ``export_s`` say
    where the trace went and how long writing it took.
    """
    if target is None or not _enabled():
        yield None
        return
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(target, exist_ok=True)
    path = os.path.join(target, f"{suffix or 'profile'}-{os.getpid()}-"
                                f"{next(_trace_seq)}.pt.trace.json")
    # by default only the thread that opens the window is recorded
    prof = profile(activities=activities, experimental_config=(
        _ExperimentalConfig(profile_all_threads=True)))
    try:
        with prof:
            yield prof
    finally:
        # as jax.profiler.trace, a block that raised still leaves its
        # trace; a window that never opened leaves none
        if prof.profiler is not None:
            t0 = time.perf_counter()
            prof.export_chrome_trace(path)
            prof.trace_path = path
            prof.export_s = time.perf_counter() - t0

