"""The port's nested spans on the CPU: the tree of one ``Engine.rank``
(``rank`` over its step's and its copy home's spans) and of a paged
decoder's ticks and prefills behind the async runtime (``tick.*``,
``prefill.*``, the ``queue`` wait ended at admission and on every shed
path); with obs off, no span and no profiler range; with obs on under
``torch.profiler``, each span also a profiler range that starts within
1 ms of the span's exported ``ts`` on the profiler's clock."""

import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._C._profiler import _ExperimentalConfig  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core.lss import LSSConfig  # noqa: E402
from repro_torch.obs.tracing import NOOP_SPAN  # noqa: E402
from repro_torch.serve import (AsyncRuntime, DeadlineExceededError,  # noqa: E402
                               Engine, LMDecoder, QueueFullError,
                               RuntimeClosedError)

PROGRAM = {"rank", "step.copy_in", "step.eager", "step.replay",
           "step.clone", "output.copy", "output.wait", "tick", "tick.admit",
           "tick.dispatch", "tick.collect", "prefill", "prefill.forward",
           "prefill.join", "prefill.head", "queue"}


@pytest.fixture(autouse=True)
def _obs_on_and_quiescent():
    was = obs.enabled()
    obs.set_enabled(True)
    obs.reset_tracer()
    yield
    obs.assert_quiescent()
    obs.reset_tracer()
    obs.set_enabled(was)


def _engine(buckets=(8,)):
    w = np.random.default_rng(0).standard_normal((256, 16)).astype(
        np.float32)
    eng = Engine(None, torch.from_numpy(w), None,
                 LSSConfig(k_bits=4, n_tables=1), top_k=3, head="lss",
                 buckets=buckets)
    eng.fit_random(torch.Generator().manual_seed(1))
    return eng


def _decoder(max_streams=2, max_len=32, kv_pages=None):
    from repro_torch.models import transformer as T
    cfg = T.TransformerConfig(name="tp-spans", n_layers=2, d_model=32,
                              n_heads=2, n_kv_heads=2, head_dim=16,
                              d_ff=64, vocab=256, dtype=torch.float32,
                              kv_chunk=32)
    params = T.init_params(torch.Generator().manual_seed(3), cfg,
                           device="cpu")
    return LMDecoder(params, cfg, max_streams=max_streams, max_len=max_len,
                     kv_layout="paged", kv_page_tokens=4, kv_pages=kv_pages)


def _spans():
    return [e for e in obs.trace_export()["traceEvents"] if e["ph"] == "X"]


def _by_id(spans):
    return {e["id"]: e for e in spans}


def _parent(e, ids):
    p = e["args"].get("parent")
    return None if p is None else ids[p]["name"]


# ------------------------------------------------------------ the tracer --

def test_with_spans_nest_per_thread_and_take_an_explicit_parent():
    outer = obs.start_span("request", rid=1)
    seen = {}

    def worker():
        with obs.span("b") as b:
            seen["b"] = b.parent

    with obs.span("a") as a:
        with obs.span("a.1") as a1:
            assert a1.parent == a.sid
            t = threading.Thread(target=worker)
            t.start()
            t.join()
        with obs.span("a.2", parent=outer, k=3) as a2:
            assert a2.parent == outer.sid and a2.attrs == {"k": 3}
    assert a.parent is None and seen["b"] is None   # per thread
    with pytest.raises(RuntimeError):
        with obs.span("boom"):
            raise RuntimeError("x")
    with obs.span("after") as after:
        pass
    assert after.parent is None                     # the stack unwound
    outer.end()
    ids = _by_id(_spans())
    status = {e["name"]: e["args"]["status"] for e in ids.values()}
    assert status["boom"] == "error" and status["a.1"] == "ok"
    assert {_parent(e, ids) for e in ids.values() if e["name"] == "a.2"} \
        == {"request"}


def test_no_span_is_lost_across_threads():
    """The tracer takes no lock: its counter, open set and ring are
    builtins whose single operations the GIL makes atomic.  Threads
    switching every microsecond each record their spans whole."""
    n_threads, n = 8, 100                 # 2,400 records: within the ring
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(n):
                with obs.span("outer", i=i):
                    with obs.span("inner"):
                        obs.event("mark")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    events = obs.trace_export()["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    assert len(spans) == 2 * n_threads * n
    assert len({e["id"] for e in spans}) == len(spans)
    ids = _by_id(spans)
    assert all(_parent(e, ids) == "outer" for e in spans
               if e["name"] == "inner")
    assert sum(e["ph"] == "i" for e in events) == n_threads * n
    assert obs.open_spans() == []


def test_export_clocks():
    with obs.span("x"):
        pass
    t_perf, t_unix = time.perf_counter(), time.time()
    perf = obs.trace_export(clock="perf_counter")
    unix = obs.trace_export(clock="profiler")
    assert unix["otherData"]["clock"] == "profiler"
    [p], [u] = perf["traceEvents"], unix["traceEvents"]
    assert abs(p["ts"] / 1e6 - t_perf) < 5.0
    assert abs((u["ts"] - p["ts"]) / 1e6 - (t_unix - t_perf)) < 1e-3
    assert u["dur"] == p["dur"]
    with pytest.raises(ValueError):
        obs.trace_export(clock="wall")


# --------------------------------------------------------- engine, step --

def test_rank_span_tree():
    eng = _engine()
    eng.rank(np.zeros((5, 16), np.float32), record=True)
    spans = _spans()
    ids = _by_id(spans)
    [rank] = [e for e in spans if e["name"] == "rank"]
    assert rank["args"]["rows"] == 5 and rank["args"]["bucket"] == 8
    assert "parent" not in rank["args"]
    kids = sorted((e["ts"], e["name"]) for e in spans
                  if _parent(e, ids) == "rank")
    assert [n for _, n in kids] == ["step.copy_in", "step.eager",
                                    "output.copy", "output.wait"]
    for e in spans:
        if e["name"] in ("step.copy_in", "output.copy"):
            assert e["args"]["pinned"] == 0         # nothing pinned here
        if e is not rank:
            assert rank["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= rank["ts"] + rank["dur"] + 1e-3


def test_obs_off_records_no_span_and_no_profiler_range():
    eng = _engine()
    dec = _decoder()
    obs.set_enabled(False)
    obs.reset_tracer()                      # the index swap's event
    assert obs.span("rank") is NOOP_SPAN
    prof = profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))
    with prof:
        eng.rank(np.zeros((3, 16), np.float32), record=True)
        sched = dec.scheduler(head="full")
        rt = AsyncRuntime(dec.engine, scheduler=sched)
        s = rt.submit_decode(np.arange(5, dtype=np.int32), max_new_tokens=3)
        s.result(timeout=60)
        rt.close(timeout=60)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "aten::matmul" in names or "aten::mm" in names
    assert not names & PROGRAM
    assert obs.trace_export()["traceEvents"] == []


def test_spans_are_profiler_ranges_on_its_clock():
    eng = _engine()
    x = np.zeros((4, 16), np.float32)

    def client():
        eng.rank(x, record=True)

    t = threading.Thread(target=client)
    obs.reset_tracer()                      # the index swap's event
    prof = profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))
    with prof:
        t.start()
        t.join()
        eng.rank(x, record=True)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in PROGRAM:
            ranges.setdefault(e.name(), []).append(e.start_ns() / 1e3)
    spans = {}
    for e in obs.trace_export(clock="profiler")["traceEvents"]:
        spans.setdefault(e["name"], []).append(e["ts"])
    assert set(spans) == set(ranges) == {
        "rank", "step.copy_in", "step.eager", "output.copy", "output.wait"}
    for name, ts in spans.items():
        assert len(ranges[name]) == len(ts) == 2, name
        for span_us, range_us in zip(sorted(ts), sorted(ranges[name])):
            assert abs(span_us - range_us) < 1e3, name


# ------------------------------------------------------- decode scheduler --

def test_tick_prefill_and_queue_span_tree():
    dec = _decoder()
    sched = dec.scheduler(head="full")
    rt = AsyncRuntime(dec.engine, scheduler=sched)
    streams = [rt.submit_decode(np.arange(1 + i, 6 + 2 * i, dtype=np.int32),
                                max_new_tokens=3) for i in range(3)]
    for s in streams:
        s.result(timeout=60)
    rt.close(timeout=60)
    spans = _spans()
    ids = _by_id(spans)
    names = [e["name"] for e in spans]
    for name in ("tick.admit", "tick.dispatch", "tick.collect"):
        assert name in names
    for e in spans:
        n, up = e["name"], _parent(e, ids)
        if n.startswith("tick."):
            assert up == "tick", e
        elif n.startswith("prefill."):
            assert up == "prefill", e
        elif n == "prefill":
            assert up == "tick.admit", e
        elif n == "tick":
            assert up is None
            assert e["args"]["slots"] == 2
            assert 0 <= e["args"]["active"] <= 2
    heads = {e["id"] for e in spans if e["name"] == "prefill.head"}
    assert sum(e["args"].get("parent") in heads for e in spans
               if e["name"] == "rank") == 3
    # the wait: one span a session, under its session, ended ok at
    # admission, before its prefill began
    queues = {e["args"]["sid"]: e for e in spans if e["name"] == "queue"}
    prefills = {e["args"]["sid"]: e for e in spans if e["name"] == "prefill"}
    assert sorted(queues) == sorted(prefills) == [0, 1, 2]
    # prompts of 5, 6 and 7 tokens: the width the forward ran at
    assert [prefills[sid]["args"]["plen"] for sid in range(3)] == [5, 6, 7]
    assert all(p["args"]["bucket"] == 8 for p in prefills.values())
    for sid, q in queues.items():
        assert q["args"]["status"] == "ok"
        assert _parent(q, ids) == "decode_session"
        assert ids[q["args"]["parent"]]["args"]["sid"] == sid
        assert q["ts"] + q["dur"] <= prefills[sid]["ts"] + 1e-3
    # the chunk span's wall time is host wall, named as such
    assert all("device_s" not in e["args"] for e in spans)


def _queue_status():
    return {e["args"]["sid"]: e["args"]["status"] for e in _spans()
            if e["name"] == "queue"}


def test_queue_span_ends_on_every_shed_path():
    dec = _decoder()
    prompt = np.arange(5, dtype=np.int32)
    # a full queue sheds at submit; a closing runtime fails what it holds
    sched = dec.scheduler(head="full")
    rt = AsyncRuntime(dec.engine, scheduler=sched, max_queue=1,
                      policy="shed", start=False)
    kept = rt.submit_decode(prompt, max_new_tokens=2)
    shed = rt.submit_decode(prompt, max_new_tokens=2)
    assert isinstance(shed.exception(timeout=5), QueueFullError)
    rt.close(timeout=30)                    # never started: fails the rest
    assert isinstance(kept.exception(timeout=5), RuntimeClosedError)
    # a submit to a closed runtime
    closed = rt.submit_decode(prompt, max_new_tokens=2)
    assert isinstance(closed.exception(timeout=5), RuntimeClosedError)
    assert _queue_status() == {kept.sid: "closed", shed.sid: "shed_queue",
                               closed.sid: "closed"}
    # a deadline that passes in the queue sheds at admission
    obs.reset_tracer()
    sched = dec.scheduler(head="full")
    rt = AsyncRuntime(dec.engine, scheduler=sched, start=False)
    late = rt.submit_decode(prompt, max_new_tokens=2, deadline_s=0.001)
    ok = rt.submit_decode(prompt, max_new_tokens=2)
    time.sleep(0.01)
    rt.start()
    assert isinstance(late.exception(timeout=60), DeadlineExceededError)
    ok.result(timeout=60)
    rt.close(timeout=60)
    assert _queue_status() == {late.sid: "shed_deadline", ok.sid: "ok"}
