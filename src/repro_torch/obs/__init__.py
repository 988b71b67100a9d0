"""Process-wide observability: metrics, tracing, exporters, recall audit
(counterpart of ``repro.obs``; numpy and the standard library only).

One spine for the serving stack's telemetry:

  * :mod:`~repro_torch.obs.metrics` — typed counters/gauges/bounded
    histograms in per-component registries, merged by the exporters;
  * :mod:`~repro_torch.obs.tracing` — spans through the serving seams
    (nested ``with obs.span(...)`` blocks on one thread, each also a
    profiler range while ``torch.profiler`` records) with a bounded ring
    and chrome://tracing export, and the deep hook
    :func:`maybe_profile` (a ``torch.profiler`` trace of a block);
  * :mod:`~repro_torch.obs.export` — Prometheus text / JSON snapshot
    over a stdlib ``http.server`` endpoint;
  * :mod:`~repro_torch.obs.audit` — the online label-recall auditor
    (``lss_audit_recall@k`` as a live gauge).

The whole subsystem sits behind one switch: ``REPRO_OBS=0`` (or
:func:`set_enabled`) makes registries hand out shared no-op metrics and
:func:`start_span` and :func:`span` return the shared no-op span — the
"compiled-out" baseline the overhead bench measures against.  Components
read the switch at construction, so toggle *before* building an
engine/runtime.
"""

from __future__ import annotations

import os

from repro_torch.obs.metrics import (DEFAULT_RESERVOIR, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     all_registries)
from repro_torch.obs.tracing import (SPAN_STATUSES, TRACE_CAP_ENV, Span,
                                     assert_quiescent, event, maybe_profile,
                                     open_spans, reset_tracer, span,
                                     start_span, status_from_exc,
                                     trace_export)

__all__ = [
    "enabled", "set_enabled", "registry", "reset",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "all_registries",
    "DEFAULT_RESERVOIR",
    "Span", "SPAN_STATUSES", "start_span", "span", "event", "trace_export",
    "assert_quiescent", "open_spans", "reset_tracer", "status_from_exc",
    "maybe_profile", "TRACE_CAP_ENV", "OBS_ENV", "AUDIT_RATE_ENV",
    "audit_rate_from_env",
]

OBS_ENV = "REPRO_OBS"
AUDIT_RATE_ENV = "REPRO_OBS_AUDIT_RATE"

_ENABLED = os.environ.get(OBS_ENV, "1") != "0"


def enabled() -> bool:
    """Is observability on for this process?"""
    return _ENABLED


def set_enabled(flag: bool) -> None:
    """Flip the process switch.  Components capture it at construction
    (registries, span call sites), so build engines/runtimes *after*
    toggling — existing ones keep their old mode."""
    global _ENABLED
    _ENABLED = bool(flag)


_GLOBAL: MetricsRegistry | None = None


def registry() -> MetricsRegistry:
    """The process-global registry (scope ``None``) for metrics not
    owned by any one component (KV-pool events, audit gauges).  A flip
    of :func:`set_enabled` replaces it at the next call; the superseded
    one is retired from the exposition (a component built before the
    flip may still hold it), so the exporters list one ``scope=None``
    registry, the current one."""
    global _GLOBAL
    if _GLOBAL is None or _GLOBAL.enabled != _ENABLED:
        if _GLOBAL is not None:
            _GLOBAL.retire()
        _GLOBAL = MetricsRegistry(None, enabled=_ENABLED)
    return _GLOBAL


def reset() -> None:
    """Fresh telemetry window: zero the global registry and clear the
    trace ring (component registries are reset by their owners)."""
    registry().reset()
    reset_tracer()


def audit_rate_from_env(default: float = 0.0) -> float:
    """Sampling fraction for the online recall auditor, clamped to
    [0, 1] (``REPRO_OBS_AUDIT_RATE``; unset/empty -> ``default``)."""
    raw = os.environ.get(AUDIT_RATE_ENV, "")
    if not raw:
        return default
    try:
        return min(1.0, max(0.0, float(raw)))
    except ValueError:
        return default
