"""The port's async serving runtime on the CPU (counterpart of
``tests/test_async_runtime.py``): admission queue policies, futures,
deadline and queue-depth shedding, drain/close semantics, multi-threaded
bit-identity against the port's synchronous ``Engine.flush``, Engine
thread safety, and one paused-runtime run against the JAX runtime."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.lss import LSSConfig as JLSSConfig  # noqa: E402
from repro.serve import AsyncRuntime as JAsyncRuntime  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro_torch.convert import lss_index_from_numpy  # noqa: E402
from repro_torch.core.lss import LSSConfig  # noqa: E402
from repro_torch.serve import (AdmissionQueue, AsyncRuntime,  # noqa: E402
                               DeadlineExceededError, Engine,
                               QueueFullError, RuntimeClosedError)
from repro_torch.testing.parity import (assert_close,  # noqa: E402
                                        assert_topk_ids_equal, margin_rows)


def _engine(m=512, d=32, k_bits=4, n_tables=2, top_k=5, buckets=(8,)):
    w = np.random.default_rng(0).standard_normal((m, d)).astype(np.float32)
    eng = Engine(None, torch.from_numpy(w), None,
                 LSSConfig(k_bits=k_bits, n_tables=n_tables),
                 top_k=top_k, head="lss", buckets=buckets)
    eng.fit_random(torch.Generator().manual_seed(1))
    return eng


# -------------------------------------------------------- admission queue --

def test_admission_queue_fifo_and_take():
    q = AdmissionQueue(maxsize=8)
    for i in range(5):
        assert q.put(i)
    assert q.take(3, timeout=5.0) == [0, 1, 2]
    assert q.take(10, timeout=5.0) == [3, 4]
    assert q.take(1, timeout=0.01) == []         # empty -> timeout


def test_admission_queue_shed_policy():
    q = AdmissionQueue(maxsize=2, policy="shed")
    assert q.put("a") and q.put("b")
    assert not q.put("c")                        # full -> shed immediately
    assert q.take(10, timeout=5.0) == ["a", "b"]
    assert q.put("c")


def test_admission_queue_block_policy_timeout_and_wakeup():
    q = AdmissionQueue(maxsize=1, policy="block")
    assert q.put("a")
    assert not q.put("b", timeout=0.05)          # blocked, then timed out
    admitted = []
    t = threading.Thread(target=lambda: admitted.append(
        q.put("c", timeout=10.0)))
    t.start()
    time.sleep(0.05)
    assert t.is_alive()                          # still blocked
    assert q.take(1, timeout=5.0) == ["a"]       # frees a slot
    t.join(timeout=5.0)
    assert not t.is_alive() and admitted == [True]
    assert q.take(1, timeout=5.0) == ["c"]


def test_admission_queue_close_returns_leftovers_and_refuses():
    q = AdmissionQueue(maxsize=8)
    q.put(1), q.put(2)
    assert q.close() == [1, 2]
    assert not q.put(3)
    assert q.take(1, timeout=5.0) == []          # returns instantly, closed


def test_admission_queue_validation():
    with pytest.raises(ValueError):
        AdmissionQueue(maxsize=0)
    with pytest.raises(ValueError):
        AdmissionQueue(policy="drop-oldest")


# ------------------------------------------------- bit-identity with flush --

def test_multithreaded_submit_bit_identical_to_flush():
    """Producer threads race submissions; every request's async result
    equals, bit for bit, the synchronous flush's (one bucket: every chunk
    goes through one step, and every head op is row-parallel)."""
    eng = _engine(buckets=(8,))
    n_threads, per_thread = 4, 16
    xs = np.random.default_rng(3).standard_normal(
        (n_threads * per_thread, 32)).astype(np.float32)
    for x in xs:
        eng.submit(x)
    sync = eng.flush()

    rt = AsyncRuntime(eng, max_queue=1024, policy="block")
    futs: dict[int, object] = {}
    barrier = threading.Barrier(n_threads)

    def producer(t):
        barrier.wait(timeout=30.0)
        for i in range(t * per_thread, (t + 1) * per_thread):
            futs[i] = rt.submit(xs[i])

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads)
    rt.drain(timeout=60.0)
    s = rt.stats()
    rt.close(timeout=30.0)
    assert s.n_completed == len(xs) and s.n_shed_queue == 0
    for i in range(len(xs)):
        r = futs[i].result(timeout=5.0)
        np.testing.assert_array_equal(r.ids, sync[i].ids)
        np.testing.assert_array_equal(r.logits, sync[i].logits)


def test_paused_runtime_matches_flush_grouping_exactly():
    eng = _engine(buckets=(1, 2, 4, 8))
    xs = np.random.default_rng(4).standard_normal((19, 32)).astype(
        np.float32)
    for x in xs:
        eng.submit(x)
    sync = eng.flush()
    rt = AsyncRuntime(eng, max_queue=64, start=False)
    futs = [rt.submit(x) for x in xs]
    rt.start()
    rt.drain(timeout=60.0)
    rt.close(timeout=30.0)
    assert rt.stats().n_batches == 3             # 8 + 8 + 3 -> bucket 4
    for i, f in enumerate(futs):
        r = f.result(timeout=5.0)
        np.testing.assert_array_equal(r.ids, sync[i].ids)
        np.testing.assert_array_equal(r.logits, sync[i].logits)


def test_paused_runtime_matches_jax_runtime():
    """The same staged backlog through the JAX runtime (impl="ref") and
    the port's, on the same w and JAX-drawn hyperplanes: ids exact on
    margin rows, logits allclose (the CPU dot products sum in other
    orders), and the engines' sample size and recall equal."""
    w = np.random.default_rng(6).standard_normal((512, 32)).astype(
        np.float32)
    jeng = JEngine(None, jnp.asarray(w), None,
                   JLSSConfig(k_bits=4, n_tables=2), top_k=5, head="lss",
                   buckets=(1, 2, 4, 8), impl="ref")
    jeng.fit_random(jax.random.PRNGKey(1))
    ji = jeng.index
    teng = Engine(None, torch.from_numpy(w), None,
                  LSSConfig(k_bits=4, n_tables=2), top_k=5, head="lss",
                  buckets=(1, 2, 4, 8))
    teng._set_index(lss_index_from_numpy(
        np.array(ji.theta), np.array(ji.tables.table_ids),
        np.array(ji.tables.n_dropped), np.array(ji.w_bucketed), None,
        4, 2, ji.tables.capacity, device="cpu"))
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((27, 32)).astype(np.float32)
    labels = rng.integers(0, 512, (27, 2)).astype(np.int32)
    results = {}
    for name, rt in (("jax", JAsyncRuntime(jeng, max_queue=64, start=False)),
                     ("port", AsyncRuntime(teng, max_queue=64,
                                           start=False))):
        futs = [rt.submit(x, labels=lab) for x, lab in zip(xs, labels)]
        rt.start()
        rt.drain(timeout=60.0)
        results[name] = ([f.result(timeout=5.0) for f in futs], rt.stats())
        rt.close(timeout=30.0)
    (jr, js), (tr, ts) = results["jax"], results["port"]
    assert ts.n_batches == js.n_batches == 4    # 8 + 8 + 8 + 3
    assert ts.avg_batch_occupancy == js.avg_batch_occupancy
    j_ids = np.stack([r.ids for r in jr])
    j_lg = np.stack([r.logits for r in jr])
    aug = np.concatenate([xs, np.zeros((27, 1), np.float32)], 1)
    rows = margin_rows(aug, teng.index.theta)
    assert rows.all()
    assert_close(np.stack([r.logits for r in tr]), j_lg, rtol=1e-5,
                 atol=1e-5, what="logits")
    assert_topk_ids_equal(np.stack([r.ids for r in tr]), j_ids, j_lg, 1e-5,
                          what="ids")
    jm, tm = jeng.metrics(), teng.metrics()
    assert tm.avg_sample_size == jm.avg_sample_size
    assert tm.label_recall == jm.label_recall


# ------------------------------------------------------- admission control --

def test_deadline_shed():
    eng = _engine()
    rt = AsyncRuntime(eng, start=False)
    futs = [rt.submit(np.zeros(32, np.float32), deadline_s=0.01)
            for _ in range(5)]
    time.sleep(0.05)                              # all five are now late
    rt.start()
    rt.drain(timeout=30.0)
    s = rt.stats()
    rt.close(timeout=30.0)
    assert s.n_shed_deadline == 5 and s.n_completed == 0
    for f in futs:
        with pytest.raises(DeadlineExceededError):
            f.result(timeout=5.0)


def test_deadline_met_when_on_time():
    eng = _engine()
    with AsyncRuntime(eng, default_deadline_s=30.0,
                      close_timeout_s=30.0) as rt:
        f = rt.submit(np.zeros(32, np.float32))
        assert f.result(timeout=30.0).ids.shape == (5,)
        assert rt.stats().n_shed_deadline == 0


def test_bounded_queue_shed_policy():
    eng = _engine()
    rt = AsyncRuntime(eng, max_queue=2, policy="shed", start=False)
    futs = [rt.submit(np.zeros(32, np.float32)) for _ in range(5)]
    shed = [f for f in futs if f.done()]
    assert len(shed) == 3                         # queue bound of 2 held
    for f in shed:
        with pytest.raises(QueueFullError):
            f.result(timeout=5.0)
    assert rt.stats().n_shed_queue == 3
    rt.start()
    rt.drain(timeout=30.0)
    assert rt.stats().n_completed == 2
    rt.close(timeout=30.0)


def test_block_policy_backpressure():
    eng = _engine()
    rt = AsyncRuntime(eng, max_queue=1, policy="block", start=False)
    rt.submit(np.zeros(32, np.float32))           # fills the queue
    blocked_fut = []
    t = threading.Thread(target=lambda: blocked_fut.append(
        rt.submit(np.ones(32, np.float32), timeout=30.0)))
    t.start()
    time.sleep(0.05)
    assert t.is_alive()                           # producer is blocked
    rt.start()                                    # dispatcher frees space
    t.join(timeout=10.0)
    assert not t.is_alive()
    rt.drain(timeout=30.0)
    assert blocked_fut[0].result(timeout=5.0) is not None
    assert rt.stats().n_completed == 2
    rt.close(timeout=30.0)


def test_block_policy_submit_timeout_sheds():
    eng = _engine()
    rt = AsyncRuntime(eng, max_queue=1, policy="block", start=False)
    rt.submit(np.zeros(32, np.float32))
    f = rt.submit(np.zeros(32, np.float32), timeout=0.02)
    with pytest.raises(QueueFullError):
        f.result(timeout=5.0)
    assert rt.stats().n_shed_queue == 1
    rt.close(timeout=30.0)


def test_malformed_request_fails_its_chunk_only():
    eng = _engine(buckets=(8,))
    with AsyncRuntime(eng, close_timeout_s=30.0) as rt:
        bad = rt.submit(np.zeros(33, np.float32))     # d=33 != 32
        assert bad.exception(timeout=30.0) is not None
        good = rt.submit(np.zeros(32, np.float32))
        assert good.result(timeout=30.0).ids.shape == (5,)
        s = rt.stats()
    assert s.n_completed == 1 and s.n_submitted == 2


def test_scheduler_waits_for_the_decode_slice():
    """The decode request kind needs a scheduler, and a scheduler serves
    one runtime at a time (it detaches on close)."""
    from repro_torch.serve.decode import DecodeScheduler
    from repro_torch.models.transformer import TransformerConfig, init_params
    rt = AsyncRuntime(_engine(), start=False)
    with pytest.raises(RuntimeError, match="DecodeScheduler"):
        rt.submit_decode(np.arange(4), max_new_tokens=2)
    rt.close(timeout=30.0)
    cfg = TransformerConfig(name="t", n_layers=1, d_model=32, n_heads=2,
                            n_kv_heads=1, head_dim=16, d_ff=32, vocab=512,
                            dtype=torch.float32)
    eng = _engine()
    sched = DecodeScheduler(eng, init_params(torch.Generator().manual_seed(0),
                                             cfg, device="cpu"),
                            cfg, max_streams=2, max_len=16, head="full")
    first = AsyncRuntime(eng, scheduler=sched, start=False)
    with pytest.raises(ValueError, match="decode"):
        AsyncRuntime(eng, scheduler=sched, start=False)
    first.close(timeout=30.0)
    AsyncRuntime(eng, scheduler=sched, start=False).close(timeout=30.0)


# ----------------------------------------------------------- drain / close --

def test_drain_on_close_completes_all_inflight():
    eng = _engine(buckets=(1, 2, 4, 8))
    rt = AsyncRuntime(eng, max_queue=256)
    futs = [rt.submit(np.full(32, i, np.float32)) for i in range(30)]
    rt.close(timeout=60.0)                        # graceful: drains first
    assert all(f.done() for f in futs)
    assert all(f.exception(timeout=5.0) is None for f in futs)
    assert rt.stats().n_completed == 30
    with pytest.raises(RuntimeClosedError):
        rt.submit(np.zeros(32, np.float32)).result(timeout=5.0)


def test_close_never_started_fails_pending():
    eng = _engine()
    rt = AsyncRuntime(eng, start=False)
    futs = [rt.submit(np.zeros(32, np.float32)) for _ in range(3)]
    with pytest.raises(RuntimeError, match="never-started"):
        rt.drain(timeout=1.0)
    rt.close(timeout=5.0)
    for f in futs:
        with pytest.raises(RuntimeClosedError):
            f.result(timeout=1.0)


def test_close_timeout_still_stops_runtime():
    eng = _engine(buckets=(8,))
    rt = AsyncRuntime(eng, max_queue=4096)
    futs = [rt.submit(np.zeros(32, np.float32)) for _ in range(512)]
    with pytest.raises(TimeoutError):
        rt.close(timeout=1e-4)                    # cannot drain in 0.1ms
    for t in rt._threads:
        t.join(timeout=10.0)
    assert not any(t.is_alive() for t in rt._threads)
    for f in futs:
        exc = f.exception(timeout=10.0)
        assert exc is None or isinstance(exc, RuntimeClosedError)
    assert any(isinstance(f.exception(0), RuntimeClosedError)
               for f in futs), "want some undrained requests failed"
    rt.close(timeout=5.0)                         # now a no-op


def test_close_is_idempotent_and_context_manager():
    eng = _engine()
    with AsyncRuntime(eng, close_timeout_s=30.0) as rt:
        rt.submit(np.zeros(32, np.float32)).result(timeout=30.0)
    rt.close(timeout=5.0)                         # second close: no-op


# ------------------------------------------------------------------ stats --

def test_stats_latency_occupancy_and_engine_metrics():
    eng = _engine(buckets=(8,))
    eng.reset_metrics()
    labels = np.arange(16, dtype=np.int32)
    with AsyncRuntime(eng, start=False, close_timeout_s=30.0) as rt:
        futs = [rt.submit(np.zeros(32, np.float32) + i, labels=labels[i])
                for i in range(16)]
        rt.start()
        rt.drain(timeout=60.0)
        s = rt.stats()
    assert all(f.result(5.0) is not None for f in futs)
    assert s.n_submitted == s.n_completed == 16
    assert s.n_batches == 2 and s.avg_batch_occupancy == 1.0
    assert s.latency_p50_ms > 0
    assert s.latency_p50_ms <= s.latency_p95_ms <= s.latency_p99_ms
    assert s.wall_s > 0 and s.throughput_rps > 0
    assert s.latency_p99_ms >= s.device_ms_per_batch / 2
    m = eng.metrics()
    assert m.n_requests == 16
    assert 0.0 <= m.label_recall <= 1.0


def test_open_loop_and_burst_match_flush():
    from repro_torch.serve.runtime import submit_open_loop
    eng = _engine(buckets=(1, 4, 16))
    xs = np.random.default_rng(8).standard_normal((64, 32)).astype(
        np.float32)
    for x in xs:
        eng.submit(x)
    sync = eng.flush()
    with AsyncRuntime(eng, max_queue=256, policy="shed",
                      close_timeout_s=30.0) as rt:
        futs, arrivals = submit_open_loop(rt, xs[:32], 2000.0, seed=0)
        burst, zeros = submit_open_loop(rt, xs[32:], 0.0)
        res = [f.result(timeout=30.0) for f in futs + burst]
    assert np.all(np.diff(arrivals) > 0) and not zeros.any()
    for r, sy in zip(res, sync):
        np.testing.assert_array_equal(r.ids, sy.ids)
        np.testing.assert_array_equal(r.logits, sy.logits)


# -------------------------------------------------- engine thread safety --

def test_engine_submit_is_thread_safe():
    eng = _engine(buckets=(1, 2, 4, 8))
    n_threads, per_thread = 8, 25
    xs = np.random.default_rng(0).standard_normal(
        (n_threads * per_thread, 32)).astype(np.float32)
    rids: list[int] = []
    barrier = threading.Barrier(n_threads)

    def producer(t):
        got = []
        barrier.wait(timeout=30.0)
        for i in range(t * per_thread, (t + 1) * per_thread):
            got.append(eng.submit(xs[i]))
        rids.extend(got)

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads)
    res = eng.flush()
    assert len(rids) == len(set(rids)) == n_threads * per_thread
    assert sorted(r.rid for r in res) == sorted(rids)
