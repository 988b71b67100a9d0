"""Typed metrics: counters, gauges, and BOUNDED streaming histograms
(counterpart of ``repro.obs.metrics``, the same code: numpy only).

Every ad-hoc stats path in the serving stack (``AsyncRuntime._lat_s``,
``Engine._lat``, the scheduler's TTFT/ITL lists) used to be an unbounded
``list[float]`` re-fed to ``np.percentile`` on every ``stats()`` call —
O(n) memory under sustained load and O(n log n) work per snapshot, both
inside the component's lock.  :class:`Histogram` replaces them:

  * **O(1) record** — one direct-indexed log-spaced bucket increment
    plus a uniform reservoir-sampling slot write (fixed capacity), so a
    week of traffic costs the same memory as a minute;
  * **O(buckets) quantiles** — computed from the reservoir (EXACT while
    ``count <= reservoir_cap``, an unbiased uniform sample past it), so
    small-window tests keep the precise percentiles they always saw;
  * the fixed log-spaced buckets feed the Prometheus exposition
    (cumulative ``le`` buckets) without touching the reservoir.

A :class:`MetricsRegistry` is a get-or-create namespace of metrics plus
optional *collector* callbacks (run at snapshot time to refresh gauges
from component state — how ``RuntimeStats``/``DecodeStats``/
``ServeMetrics`` counters surface without double bookkeeping).  Every
registry created while observability is enabled self-registers in a
process-wide weak set so the exporters can merge all live registries;
a ``scope`` label keeps two engines' metrics distinct in one exposition.

When observability is disabled (``REPRO_OBS=0`` or
:func:`repro_torch.obs.set_enabled`), registries hand out shared
no-op metrics whose methods are empty — the "compiled-out" baseline the
observability-overhead bench compares against.
"""

from __future__ import annotations

import math
import random
import threading
import weakref
from typing import Callable

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "all_registries", "DEFAULT_RESERVOIR"]

DEFAULT_RESERVOIR = 4096

# live registries, merged by the exporters (weak: registries die with
# the engine/runtime that owns them)
_REGISTRIES: "weakref.WeakSet[MetricsRegistry]" = weakref.WeakSet()
_REG_LOCK = threading.Lock()
_SCOPE_SEQ: dict[str, int] = {}


def all_registries() -> list["MetricsRegistry"]:
    """Every live registry, registration order not guaranteed."""
    with _REG_LOCK:
        return list(_REGISTRIES)


def _next_scope(prefix: str) -> str:
    with _REG_LOCK:
        n = _SCOPE_SEQ.get(prefix, 0)
        _SCOPE_SEQ[prefix] = n + 1
    return f"{prefix}{n}"


class Counter:
    """Monotonically increasing accumulator (float-valued so wall-time
    sums can live here too)."""

    __slots__ = ("name", "help", "_mu", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._mu = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._mu:
            self._value += n

    @property
    def value(self) -> float:
        with self._mu:
            return self._value

    def reset(self) -> None:
        with self._mu:
            self._value = 0.0


class Gauge:
    """Point-in-time value (set-only; collectors refresh it)."""

    __slots__ = ("name", "help", "_mu", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._mu = threading.Lock()
        self._value = math.nan

    def set(self, v: float) -> None:
        with self._mu:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._mu:
            return self._value

    def reset(self) -> None:
        with self._mu:
            self._value = math.nan


class Histogram:
    """Bounded streaming histogram: log-spaced buckets + reservoir.

    ``lo``/``hi`` bound the log-spaced bucket grid (values outside clamp
    to the edge buckets); ``per_decade`` sets resolution.  ``record`` is
    O(1); ``quantile`` is O(reservoir) and EXACT while the observation
    count fits the reservoir (the common test-window case), an unbiased
    sample estimate beyond it.  Memory is fixed at construction no
    matter how many values are recorded — the soak regression in
    tests/test_obs.py pins this.
    """

    __slots__ = ("name", "help", "lo", "hi", "_log_lo", "_inv_log_step",
                 "bounds", "_mu", "_bucket_counts", "_count", "_sum",
                 "_reservoir", "_cap", "_rng")

    def __init__(self, name: str, help: str = "", *, lo: float = 1e-3,
                 hi: float = 1e6, per_decade: int = 10,
                 reservoir: int = DEFAULT_RESERVOIR):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
        self.name = name
        self.help = help
        self.lo = lo
        self.hi = hi
        n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
        self._log_lo = math.log10(lo)
        self._inv_log_step = per_decade
        # upper bound of bucket i; the last bucket is +inf (Prometheus
        # convention), so every value lands somewhere
        self.bounds = [lo * 10 ** (i / per_decade) for i in range(n)]
        self.bounds.append(math.inf)
        self._mu = threading.Lock()
        self._bucket_counts = [0] * len(self.bounds)
        self._count = 0
        self._sum = 0.0
        self._reservoir: list[float] = []
        self._cap = int(reservoir)
        self._rng = random.Random(0xC0FFEE ^ hash(name))

    def record(self, v: float) -> None:
        v = float(v)
        if v <= 0 or math.isnan(v):
            idx = 0                       # non-positive -> first bucket
        else:
            idx = int((math.log10(v) - self._log_lo) * self._inv_log_step)
            idx = min(max(idx + 1, 0), len(self.bounds) - 1)
        with self._mu:
            self._bucket_counts[idx] += 1
            self._count += 1
            self._sum += v
            if len(self._reservoir) < self._cap:
                self._reservoir.append(v)
            else:                         # uniform reservoir sampling
                j = self._rng.randrange(self._count)
                if j < self._cap:
                    self._reservoir[j] = v

    @property
    def count(self) -> int:
        with self._mu:
            return self._count

    @property
    def sum(self) -> float:
        with self._mu:
            return self._sum

    def sample(self) -> np.ndarray:
        """Copy of the reservoir (exact sample set while count <= cap).
        Cheap O(cap) snapshot; quantile math belongs OUTSIDE any caller
        lock (see the stats() satellite in runtime.py)."""
        with self._mu:
            return np.asarray(self._reservoir, np.float64)

    def quantile(self, q) -> float | tuple[float, ...]:
        """Percentile(s) of the recorded distribution; ``q`` in [0, 100]
        (scalar or sequence), nan when empty."""
        arr = self.sample()
        scalar = np.isscalar(q)
        if not arr.size:
            return math.nan if scalar else (math.nan,) * len(q)
        p = np.percentile(arr, q)
        return float(p) if scalar else tuple(float(x) for x in p)

    def mean(self) -> float:
        with self._mu:
            return self._sum / self._count if self._count else math.nan

    def bucket_snapshot(self) -> list[tuple[float, int]]:
        """Cumulative (le_bound, count) pairs — Prometheus layout."""
        with self._mu:
            counts = list(self._bucket_counts)
        out, cum = [], 0
        for le, c in zip(self.bounds, counts):
            cum += c
            out.append((le, cum))
        return out

    def reset(self) -> None:
        with self._mu:
            self._bucket_counts = [0] * len(self.bounds)
            self._count = 0
            self._sum = 0.0
            self._reservoir = []


class _NoopMetric:
    """Shared stand-in when observability is disabled: every method is a
    no-op, every read is empty/nan.  One instance serves all names."""

    __slots__ = ()
    name = "noop"
    help = ""

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def record(self, v: float) -> None:
        pass

    def reset(self) -> None:
        pass

    count = 0
    sum = 0.0
    value = math.nan

    def sample(self) -> np.ndarray:
        return np.empty(0, np.float64)

    def quantile(self, q) -> float | tuple[float, ...]:
        return math.nan if np.isscalar(q) else (math.nan,) * len(q)

    def mean(self) -> float:
        return math.nan

    def bucket_snapshot(self) -> list[tuple[float, int]]:
        return []


NOOP_METRIC = _NoopMetric()


class MetricsRegistry:
    """Get-or-create namespace of metrics + snapshot-time collectors.

    ``scope`` becomes a label on every exported metric so registries
    from different components can merge into one exposition without
    colliding (``scope_prefix`` auto-numbers: ``engine0``, ``engine1``,
    ...).  ``enabled=None`` follows the process switch at construction
    time (``repro_torch.obs.enabled()``); a disabled registry hands out the
    shared no-op metric and exports nothing.
    """

    def __init__(self, scope: str | None = None, *,
                 scope_prefix: str | None = None,
                 enabled: bool | None = None):
        if enabled is None:
            from repro_torch import obs
            enabled = obs.enabled()
        self.enabled = bool(enabled)
        if scope is None and scope_prefix is not None:
            scope = _next_scope(scope_prefix)
        self.scope = scope
        self._mu = threading.Lock()
        self._metrics: dict[str, object] = {}
        self._collectors: list[Callable[["MetricsRegistry"], None]] = []
        if self.enabled:
            with _REG_LOCK:
                _REGISTRIES.add(self)

    def retire(self) -> None:
        """Leave the exposition: the exporters no longer list this
        registry; its metrics still count for whoever holds it."""
        with _REG_LOCK:
            _REGISTRIES.discard(self)

    # ----------------------------------------------------- get-or-create --
    def _get(self, name: str, factory: Callable, cls: type):
        if not self.enabled:
            return NOOP_METRIC
        with self._mu:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help), Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help), Gauge)

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self._get(name, lambda: Histogram(name, help, **kw),
                         Histogram)

    # --------------------------------------------------------- snapshots --
    def collect(self, fn: Callable[["MetricsRegistry"], None]) -> None:
        """Register a snapshot-time callback that refreshes gauges from
        component state (e.g. ``RuntimeStats`` counters)."""
        with self._mu:
            self._collectors.append(fn)

    def run_collectors(self) -> None:
        with self._mu:
            collectors = list(self._collectors)
        for fn in collectors:
            fn(self)

    def metrics(self) -> dict[str, object]:
        with self._mu:
            return dict(self._metrics)

    def snapshot(self) -> dict:
        """Plain-data view (JSON-ready) of every metric, collectors run
        first.  Histograms carry count/sum/p50/p95/p99 + the cumulative
        bucket table."""
        self.run_collectors()
        out: dict = {"scope": self.scope, "metrics": {}}
        for name, m in sorted(self.metrics().items()):
            if isinstance(m, Counter):
                out["metrics"][name] = {"type": "counter",
                                        "value": m.value}
            elif isinstance(m, Gauge):
                out["metrics"][name] = {"type": "gauge", "value": m.value}
            elif isinstance(m, Histogram):
                p50, p95, p99 = m.quantile((50, 95, 99))
                out["metrics"][name] = {
                    "type": "histogram", "count": m.count, "sum": m.sum,
                    "p50": p50, "p95": p95, "p99": p99,
                    "buckets": [[le if math.isfinite(le) else "inf", c]
                                for le, c in m.bucket_snapshot()],
                }
        return out

    def reset(self) -> None:
        """Fresh window: zero every metric (the registry keeps its
        identity — callers hold metric references)."""
        for m in self.metrics().values():
            m.reset()
