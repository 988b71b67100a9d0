"""The port's observability spine on the CPU (counterpart of the pure
parts of ``tests/test_obs.py``): bounded histograms (fed the same values
as the JAX package's, whose quantiles they must equal), registry
semantics, the no-op mode, the Prometheus/JSON/trace exporters (the same
text as the JAX package's for the same registry), span statuses on every
failure path of the port's runtime, and the online recall auditor
against an offline brute-force rerank, and the KV-OOM span of a decode
session shed at a page boundary."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs.export import prometheus_text as j_prometheus_text  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.lss import LSSConfig  # noqa: E402
from repro_torch.obs.audit import RecallAuditor  # noqa: E402
from repro_torch.obs.export import (MetricsServer,  # noqa: E402
                                    json_snapshot, prometheus_text)
from repro_torch.obs.metrics import NOOP_METRIC  # noqa: E402
from repro_torch.obs.tracing import NOOP_SPAN  # noqa: E402
from repro_torch.serve import (AsyncRuntime,  # noqa: E402
                               DeadlineExceededError, Engine,
                               KVPoolExhaustedError, LMDecoder,
                               RuntimeClosedError)
from tools.check_metrics import parse_exposition  # noqa: E402


@pytest.fixture(autouse=True)
def _span_hygiene():
    """Every test starts with a clean trace ring and must leave no span
    open — the span-leak regression for every failure path below."""
    obs.reset_tracer()
    yield
    obs.assert_quiescent()
    obs.reset_tracer()


def _engine(m=512, d=32, top_k=5, buckets=(8,), audit_rate=None):
    w = np.random.default_rng(0).standard_normal((m, d)).astype(np.float32)
    eng = Engine(None, torch.from_numpy(w), None,
                 LSSConfig(k_bits=4, n_tables=2), top_k=top_k, head="lss",
                 buckets=buckets, audit_rate=audit_rate)
    eng.fit_random(torch.Generator().manual_seed(1))
    return eng


# -------------------------------------------------------------- metrics --

def test_histogram_quantiles_exact_under_reservoir_cap():
    h = obs.Histogram("h_exact")
    jh = jmetrics.Histogram("h_exact")
    vals = np.random.default_rng(0).lognormal(0.0, 2.0, size=1000)
    for v in vals:
        h.record(v)
        jh.record(v)
    assert h.count == 1000
    assert h.quantile(50) == np.percentile(vals, 50)
    p50, p95, p99 = h.quantile((50, 95, 99))
    assert (p50, p95, p99) == tuple(np.percentile(vals, (50, 95, 99)))
    assert (p50, p95, p99) == jh.quantile((50, 95, 99))
    assert h.bucket_snapshot() == jh.bucket_snapshot()
    assert h.mean() == pytest.approx(vals.mean())


def test_histogram_empty_and_edge_values():
    h = obs.Histogram("h_edge")
    assert np.isnan(h.quantile(50)) and np.isnan(h.mean())
    assert all(np.isnan(v) for v in h.quantile((50, 99)))
    h.record(0.0)                       # non-positive -> first bucket
    h.record(-3.0)
    h.record(1e12)                      # beyond hi -> +inf bucket
    assert h.count == 3
    snap = h.bucket_snapshot()
    assert snap[0][1] == 2 and snap[-1] == (float("inf"), 3)
    with pytest.raises(ValueError):
        obs.Histogram("bad", lo=1.0, hi=0.5)


def test_soak_bounded_memory():
    """200k records do not grow the histogram past its construction
    footprint, and 3x the trace cap of spans do not grow the ring."""
    h = obs.Histogram("h_soak", reservoir=512)
    n_buckets = len(h.bounds)
    for v in np.random.default_rng(1).lognormal(0.0, 3.0, size=200_000):
        h.record(v)
    assert h.count == 200_000
    assert len(h.sample()) == 512               # reservoir pinned at cap
    assert len(h.bounds) == n_buckets           # bucket grid never grows
    assert h.bucket_snapshot()[-1][1] == 200_000
    q = h.quantile((50, 95, 99))
    assert all(np.isfinite(q)) and q[0] <= q[1] <= q[2]
    for i in range(3 * 4096):
        obs.start_span("soak", i=i).end()
    assert len(obs.trace_export()["traceEvents"]) <= 4096


def test_registry_get_or_create_and_type_mismatch():
    reg = obs.MetricsRegistry("t0", enabled=True)
    c = reg.counter("hits", "help text")
    assert reg.counter("hits") is c
    c.inc(), c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(TypeError):
        reg.gauge("hits")
    g = reg.gauge("depth")
    g.set(7)
    assert g.value == 7.0
    assert reg in obs.all_registries()
    a = obs.MetricsRegistry(scope_prefix="tscope")
    b = obs.MetricsRegistry(scope_prefix="tscope")
    assert a.scope != b.scope and a.scope.startswith("tscope")


def test_registry_snapshot_collectors_and_reset():
    reg = obs.MetricsRegistry("t1", enabled=True)
    reg.counter("n").inc(4)
    reg.histogram("lat").record(0.5)
    reg.collect(lambda r: r.gauge("live").set(42.0))
    snap = reg.snapshot()
    assert snap["scope"] == "t1"
    assert snap["metrics"]["n"] == {"type": "counter", "value": 4.0}
    assert snap["metrics"]["live"]["value"] == 42.0
    assert snap["metrics"]["lat"]["count"] == 1
    json.dumps(snap)                            # JSON-ready by contract
    reg.reset()
    assert reg.counter("n").value == 0.0
    assert reg.histogram("lat").count == 0


def test_noop_mode_hands_out_shared_stubs():
    prev = obs.enabled()
    obs.set_enabled(False)
    try:
        reg = obs.MetricsRegistry("off")
        assert reg.counter("c") is NOOP_METRIC
        assert reg.histogram("h") is NOOP_METRIC
        NOOP_METRIC.inc(), NOOP_METRIC.record(1.0), NOOP_METRIC.set(2.0)
        assert np.isnan(NOOP_METRIC.quantile(50))
        assert reg not in obs.all_registries()
        span = obs.start_span("s")
        assert span is NOOP_SPAN
        span.event("e"), span.end()
        obs.event("instant")                    # swallowed, not recorded
        assert obs.trace_export()["traceEvents"] == []
        assert obs.registry().enabled is False
    finally:
        obs.set_enabled(prev)
    assert obs.registry().enabled is prev


def test_audit_rate_from_env(monkeypatch):
    monkeypatch.delenv(obs.AUDIT_RATE_ENV, raising=False)
    assert obs.audit_rate_from_env(0.25) == 0.25
    for raw, want in (("0.5", 0.5), ("7", 1.0), ("-1", 0.0), ("x", 0.0)):
        monkeypatch.setenv(obs.AUDIT_RATE_ENV, raw)
        assert obs.audit_rate_from_env() == want


# ------------------------------------------------------------ exporters --

def _fill(reg, h_values):
    reg.counter("ptest_requests_total", "served").inc(3)
    reg.gauge("ptest_depth", "queue depth").set(2)
    h = reg.histogram("ptest_lat_seconds", "latency")
    for v in h_values:
        h.record(v)


def test_prometheus_text_is_valid_exposition_and_matches_jax():
    vals = (0.001, 0.01, 0.1, 1.0, 10.0)
    reg = obs.MetricsRegistry("promtest", enabled=True)
    _fill(reg, vals)
    jreg = jmetrics.MetricsRegistry("promtest", enabled=True)
    _fill(jreg, vals)
    text = prometheus_text([reg])
    assert text == j_prometheus_text([jreg])
    families, errors = parse_exposition(text)
    assert errors == []
    assert families["ptest_requests_total"]["type"] == "counter"
    assert families["ptest_lat_seconds"]["type"] == "histogram"
    counts = [v for n, _, v in families["ptest_lat_seconds"]["samples"]
              if n.endswith("_bucket")]
    assert counts == sorted(counts) and counts[-1] == 5.0
    assert 'scope="promtest"' in text
    snap = json_snapshot([reg])
    assert snap["registries"][0]["metrics"]["ptest_depth"]["value"] == 2.0


def test_metrics_server_routes():
    reg = obs.MetricsRegistry("srvtest", enabled=True)
    reg.counter("srv_up").inc()
    with MetricsServer(port=0) as srv:
        base = f"http://{srv.host}:{srv.port}"
        with urllib.request.urlopen(srv.url, timeout=30) as r:
            assert r.status == 200
            body = r.read().decode()
        assert "srv_up" in body
        assert parse_exposition(body)[1] == []
        with urllib.request.urlopen(base + "/metrics.json", timeout=30) as r:
            snap = json.load(r)
        assert any(s.get("scope") == "srvtest" for s in snap["registries"])
        with urllib.request.urlopen(base + "/trace", timeout=30) as r:
            assert "traceEvents" in json.load(r)
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=30)


def test_trace_export_chrome_format(tmp_path):
    s = obs.start_span("outer", rid=1)
    s.event("mark", detail="x")
    s.end("ok", extra=2)
    obs.event("global_instant", pid=3)
    hung = obs.start_span("hung")
    out = obs.trace_export(str(tmp_path / "trace.json"))
    hung.end("error")                           # close before teardown
    on_disk = json.loads((tmp_path / "trace.json").read_text())
    assert out["traceEvents"] == on_disk["traceEvents"]
    by_ph = {}
    for ev in out["traceEvents"]:
        by_ph.setdefault(ev["ph"], []).append(ev)
    [outer] = [e for e in by_ph["X"] if e["name"] == "outer"]
    assert outer["args"] == {"rid": 1, "extra": 2, "status": "ok"}
    assert outer["dur"] >= 0
    names = {e["name"] for e in by_ph["i"]}
    assert {"outer.mark", "global_instant"} <= names
    assert [e["name"] for e in by_ph["B"]] == ["hung"]
    with pytest.raises(ValueError):
        obs.start_span("x").end("not-a-status")
    obs.reset_tracer()


# -------------------------------------------- non-blocking stats snapshot --

def _held(lock) -> bool:
    if hasattr(lock, "locked"):
        return lock.locked()
    return lock._is_owned()


class _QuantileSpy:
    """Records whether a lock was held when quantile math ran."""

    def __init__(self, h, lock):
        self._h, self._lock = h, lock
        self.locked_during: list[bool] = []

    def __getattr__(self, name):
        return getattr(self._h, name)

    def quantile(self, q):
        self.locked_during.append(_held(self._lock))
        return self._h.quantile(q)

    def mean(self):
        self.locked_during.append(_held(self._lock))
        return self._h.mean()


def test_stats_quantiles_run_outside_locks():
    eng = _engine()
    with AsyncRuntime(eng, close_timeout_s=30.0) as rt:
        for _ in range(8):
            rt.submit(np.zeros(32, np.float32))
        rt.drain(timeout=60.0)
        lat_spy = _QuantileSpy(rt._h_lat, rt._mu)
        dev_spy = _QuantileSpy(rt._h_device, rt._mu)
        rt._h_lat, rt._h_device = lat_spy, dev_spy
        s = rt.stats()
        rt._h_lat, rt._h_device = lat_spy._h, dev_spy._h
    assert s.latency_p50_ms > 0
    assert lat_spy.locked_during == [False]
    assert dev_spy.locked_during == [False]
    espy = _QuantileSpy(eng._h_lat, eng.lock)
    eng._h_lat = espy
    m = eng.metrics()
    eng._h_lat = espy._h
    assert m.n_requests == 8
    assert espy.locked_during == [False]


# ------------------------------------------------ span integrity: sheds --

def test_queue_shed_spans_end_with_shed_queue():
    eng = _engine()
    rt = AsyncRuntime(eng, max_queue=2, policy="shed", start=False)
    futs = [rt.submit(np.zeros(32, np.float32)) for _ in range(5)]
    shed = [f for f in futs if f.done()]
    assert len(shed) == 3
    assert all(f.span.status == "shed_queue" for f in shed)
    rt.start()
    rt.drain(timeout=60.0)
    rt.close(timeout=30.0)
    served = [f for f in futs if f not in shed]
    assert all(f.span.status == "ok" for f in served)


def test_deadline_shed_spans_end_with_shed_deadline():
    eng = _engine()
    rt = AsyncRuntime(eng, start=False)
    futs = [rt.submit(np.zeros(32, np.float32), deadline_s=0.01)
            for _ in range(3)]
    time.sleep(0.05)
    rt.start()
    rt.drain(timeout=60.0)
    rt.close(timeout=30.0)
    for f in futs:
        assert isinstance(f.exception(5.0), DeadlineExceededError)
        assert f.span.status == "shed_deadline"


def test_close_fails_pending_spans_with_closed():
    eng = _engine()
    rt = AsyncRuntime(eng, start=False)
    f = rt.submit(np.zeros(32, np.float32))
    rt.close(timeout=5.0)
    assert isinstance(f.exception(5.0), RuntimeClosedError)
    assert f.span.status == "closed"


def test_chunk_fault_spans_end_with_error_and_isolate():
    eng = _engine(buckets=(8,))
    with AsyncRuntime(eng, close_timeout_s=30.0) as rt:
        bad = rt.submit(np.zeros(33, np.float32))    # d=33 != 32
        assert bad.exception(timeout=60.0) is not None
        good = rt.submit(np.zeros(32, np.float32))
        assert good.result(timeout=60.0) is not None
    assert bad.span.status == "error"
    assert good.span.status == "ok"
    chunk_status = [e["args"]["status"]
                    for e in obs.trace_export()["traceEvents"]
                    if e["ph"] == "X" and e["name"] == "chunk"]
    assert "error" in chunk_status and "ok" in chunk_status


# --------------------------------------------------------- recall audit --

def test_kv_oom_shed_span_and_event():
    """A decode session starved at a page boundary fails with
    KVPoolExhaustedError: its decode_session span must end shed_kv_oom,
    the survivor's must end ok, and the shed_kv_oom instant event must
    land in the trace."""
    from repro_torch.data.synthetic import lm_dataset
    from repro_torch.models import transformer as T
    cfg = T.TransformerConfig(name="tp-obs", n_layers=2, d_model=32,
                              n_heads=2, n_kv_heads=2, head_dim=16,
                              d_ff=64, vocab=256, dtype=torch.float32,
                              kv_chunk=32)
    params = T.init_params(torch.Generator().manual_seed(3), cfg,
                           device="cpu")
    toks = lm_dataset(0, 8 * 17, 256, 17)
    dec = LMDecoder(params, cfg, max_streams=2, max_len=16,
                    kv_layout="paged", kv_page_tokens=4, kv_pages=4)
    sched = dec.scheduler(head="full")
    rt = AsyncRuntime(dec.engine, scheduler=sched, start=False)
    starved = rt.submit_decode(toks[0, :3], max_new_tokens=10)
    survivor = rt.submit_decode(toks[1, :5], max_new_tokens=2)
    rt.start()
    rt.drain(timeout=120.0)
    rt.close(timeout=120.0)
    assert isinstance(starved.exception(timeout=5.0), KVPoolExhaustedError)
    assert starved.span.status == "shed_kv_oom"
    assert survivor.finish_reason == "max_tokens"
    assert survivor.span.status == "ok"
    oom_events = [e for e in obs.trace_export()["traceEvents"]
                  if e["name"] == "shed_kv_oom"]
    assert oom_events


def test_audit_recall_matches_offline_brute_force_exactly():
    """At rate 1.0 the auditor's cumulative recall EQUALS the offline
    brute-force recall of the same served traffic (integer counts)."""
    eng = _engine(buckets=(8,), audit_rate=1.0)
    assert eng.auditor is not None and eng.auditor.rate == 1.0
    xs = np.random.default_rng(7).standard_normal((32, 32)).astype(
        np.float32)
    for i in range(0, 32, 8):
        eng.rank(xs[i:i + 8], head="lss", record=True)
    eng.auditor.drain(timeout=60.0)
    online = eng.auditor.recall
    assert eng.auditor.n_rows == 32
    hits_snap, total_snap = eng.auditor.snapshot()
    eng.auditor.close()

    hits = total = 0
    for i in range(0, 32, 8):
        x = xs[i:i + 8]
        served = eng.rank(x, head="lss", record=False).ids.numpy()
        exact = eng.rank(x, head="full", record=False).ids.numpy()
        hit = (exact[:, :, None] == served[:, None, :]).any(-1)
        hits, total = hits + int(hit.sum()), total + hit.size
    assert (hits_snap, total_snap) == (hits, total)
    assert online == hits / total
    gauge = obs.registry().gauge("lss_audit_recall_at_k")
    assert gauge.value == hits / total


def test_audit_never_audits_exact_head_traffic():
    eng = _engine(buckets=(8,), audit_rate=1.0)
    eng.rank(np.zeros((8, 32), np.float32), head="full", record=True)
    eng.auditor.drain(timeout=30.0)
    assert eng.auditor.n_rows == 0              # full head needs no audit
    eng.auditor.close()


def test_audit_backlog_bounded_drops_count_as_staleness():
    gate = threading.Event()

    class _SlowEngine:
        def rank(self, x, head="full", record=False):
            gate.wait(timeout=10.0)

            class Out:
                ids = np.zeros((1, 2), np.int64)
            return Out()

    reg = obs.MetricsRegistry("audittest", enabled=True)
    aud = RecallAuditor(_SlowEngine(), 1.0, queue_cap=1, registry=reg)
    row = (np.zeros((1, 4), np.float32), np.zeros((1, 2), np.int64))
    assert aud.offer(*row)                      # worker takes it, blocks
    deadline = time.monotonic() + 5.0
    while aud._q.qsize() and time.monotonic() < deadline:
        time.sleep(0.005)                       # wait for the dequeue
    assert aud.offer(*row)                      # refills the cap-1 queue
    assert not aud.offer(*row)                  # full -> shed, not block
    assert reg.counter("lss_audit_dropped_total").value == 1.0
    gate.set()
    aud.drain(timeout=30.0)
    aud.close()
    assert aud.n_rows == 2
    assert reg.counter("lss_audit_rows_total").value == 2.0


def test_audit_offer_thunk_only_materialized_when_sampled():
    calls = []

    class _NullEngine:
        def rank(self, x, head="full", record=False):
            class Out:
                ids = np.zeros((1, 2), np.int64)
            return Out()

    reg = obs.MetricsRegistry("thunktest", enabled=True)
    aud = RecallAuditor(_NullEngine(), 0.0, registry=reg)
    aud.offer(lambda: calls.append(1), np.zeros((1, 2), np.int64))
    assert calls == []                          # rate 0: thunk never runs
    aud.close()
    aud2 = RecallAuditor(_NullEngine(), 1.0, registry=reg, seed=1)
    aud2.offer(lambda: (calls.append(1),
                        np.zeros((1, 4), np.float32))[1],
               np.zeros((1, 2), np.int64))
    aud2.drain(timeout=30.0)
    aud2.close()
    assert calls == [1]                         # rate 1: materialized once
