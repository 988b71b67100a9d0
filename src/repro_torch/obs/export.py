"""Exporters: Prometheus text format + JSON snapshot + a stdlib HTTP
endpoint (counterpart of ``repro.obs.export``, the same code).

No third-party client library — the exposition format is a few lines of
text (https://prometheus.io/docs/instrumenting/exposition_formats/) and
the endpoint is ``http.server``, so the serving launcher can expose
``/metrics`` with zero new dependencies:

  * ``/metrics``        Prometheus text format, all live registries
                        merged (each registry's ``scope`` becomes a
                        label, so two engines never collide);
  * ``/metrics.json``   the same data as a JSON snapshot;
  * ``/trace``          the chrome://tracing export of the span ring.

Histograms render the standard triplet — ``_bucket{le=...}`` cumulative
counts, ``_sum``, ``_count`` — plus ``_p50/_p95/_p99`` convenience
gauges (quantiles computed server-side from the bounded reservoir).

``tools/check_metrics.py`` (stdlib again) parses and validates this
output in CI, so the format can't silently rot.
"""

from __future__ import annotations

import json
import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, all_registries)

__all__ = ["prometheus_text", "json_snapshot", "MetricsServer",
           "set_global_labels"]

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")

# process-wide labels stamped on EVERY exported sample — multi-host
# serving sets process="<rank>" here so each host's /metrics stays
# attributable after aggregation (the launcher passes the process
# index in)
_GLOBAL_LABELS: dict[str, str] = {}


def set_global_labels(**labels: str) -> None:
    """Attach labels to every sample this process exports (e.g.
    ``set_global_labels(process="0")`` on a multi-host fleet).  Repeated
    calls merge; a None value removes the label."""
    for k, v in labels.items():
        if v is None:
            _GLOBAL_LABELS.pop(k, None)
        else:
            _GLOBAL_LABELS[k] = str(v)


def _prom_name(name: str) -> str:
    return _NAME_OK.sub("_", name)


def _fmt(v: float) -> str:
    if v != v:                                    # nan
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v)) if not float(v).is_integer() else str(int(v))


def _labels(scope: str | None, extra: dict | None = None) -> str:
    parts = []
    for k, v in _GLOBAL_LABELS.items():
        parts.append(f'{k}="{v}"')
    if scope:
        parts.append(f'scope="{scope}"')
    for k, v in (extra or {}).items():
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text(registries: list[MetricsRegistry] | None = None) -> str:
    """Render registries (default: every live one) as Prometheus text.
    ``# TYPE`` lines are emitted once per metric name across registries
    (the format forbids repeats)."""
    if registries is None:
        registries = all_registries()
    lines: list[str] = []
    typed: set[str] = set()

    def header(name: str, kind: str, help_: str) -> None:
        if name in typed:
            return
        typed.add(name)
        if help_:
            lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")

    for reg in sorted(registries, key=lambda r: (r.scope or "")):
        reg.run_collectors()
        for raw, m in sorted(reg.metrics().items()):
            name = _prom_name(raw)
            if isinstance(m, Counter):
                header(name, "counter", m.help)
                lines.append(f"{name}{_labels(reg.scope)} {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                header(name, "gauge", m.help)
                lines.append(f"{name}{_labels(reg.scope)} {_fmt(m.value)}")
            elif isinstance(m, Histogram):
                header(name, "histogram", m.help)
                for le, cum in m.bucket_snapshot():
                    lab = _labels(reg.scope, {"le": _fmt(le)})
                    lines.append(f"{name}_bucket{lab} {cum}")
                lines.append(f"{name}_sum{_labels(reg.scope)} "
                             f"{_fmt(m.sum)}")
                lines.append(f"{name}_count{_labels(reg.scope)} "
                             f"{m.count}")
                p50, p95, p99 = m.quantile((50, 95, 99))
                for q, v in (("p50", p50), ("p95", p95), ("p99", p99)):
                    qn = f"{name}_{q}"
                    header(qn, "gauge",
                           f"{q} of {name} (bounded-reservoir estimate)")
                    lines.append(f"{qn}{_labels(reg.scope)} {_fmt(v)}")
    return "\n".join(lines) + "\n"


def json_snapshot(registries: list[MetricsRegistry] | None = None) -> dict:
    if registries is None:
        registries = all_registries()
    return {"labels": dict(_GLOBAL_LABELS),
            "registries": [reg.snapshot() for reg in sorted(
                registries, key=lambda r: (r.scope or ""))]}


class _Handler(BaseHTTPRequestHandler):
    server: "MetricsServer._Server"

    def _send(self, body: bytes, ctype: str, code: int = 200) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:                      # noqa: N802 (stdlib API)
        from repro_torch.obs.tracing import trace_export
        path = self.path.split("?")[0]
        try:
            if path in ("/metrics", "/"):
                self._send(prometheus_text().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/metrics.json":
                self._send(json.dumps(json_snapshot()).encode(),
                           "application/json")
            elif path == "/trace":
                self._send(json.dumps(trace_export()).encode(),
                           "application/json")
            else:
                self._send(b"not found: try /metrics, /metrics.json, "
                           b"/trace", "text/plain", 404)
        except BrokenPipeError:                    # scraper went away
            pass

    def log_message(self, *a) -> None:             # silence per-request logs
        pass


class MetricsServer:
    """Background ``/metrics`` endpoint over every live registry.

    ``port=0`` binds an ephemeral port (``.port`` reports the real one).
    The server thread is a daemon, so a launcher that exits without
    ``close()`` doesn't hang — but call ``close()`` for a clean stop.
    """

    class _Server(ThreadingHTTPServer):
        daemon_threads = True
        allow_reuse_address = True

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._httpd = self._Server((host, port), _Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="repro-obs-metrics",
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
