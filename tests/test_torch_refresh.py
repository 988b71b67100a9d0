"""The port's online index refresh on the CPU (counterpart of
``tests/test_refresh.py``, at its sizes): the IndexRefresher's refit ->
guarded swap -> probation cycle through the fault-injection harness
(fail / slow / corrupt-recall), automatic rollback asserted on the
``lss_refresh_rollback_total`` counter and ``lss_audit_recall_at_k``
gauge, bit-identical serving vs cold-built engines across a swap,
index-epoch pinning for in-flight decode sessions (directed and a
property over interleaved swap/join/leave/rank sequences), the
refit-off-the-lock regression, a step build that holds no engine lock,
bounded AsyncRuntime close on a wedged dispatcher, and /metrics port
release.  Then parity with the JAX package: both engines swapped to the
same hyperplanes serve the same ids, and both fault harnesses answer the
same arm/fire sequence the same way.

On the CPU a step runs eagerly; ``tests/test_torch_cuda_kernels.py``
holds the swap path's captures on the card."""

import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core.lss import LSSConfig as JLSSConfig  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.refresh import IndexRefresher as JIndexRefresher  # noqa: E402
from repro.serve.refresh import RefreshConfig as JRefreshConfig  # noqa: E402
from repro.testing import faults as jfaults  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.core.lss import LSSConfig  # noqa: E402
from repro_torch.data.synthetic import lm_dataset  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.obs.export import MetricsServer, prometheus_text  # noqa: E402
from repro_torch.serve import AsyncRuntime, Engine, LMDecoder  # noqa: E402
from repro_torch.serve.refresh import (IndexRefresher,  # noqa: E402
                                       RefreshConfig)
from repro_torch.testing import faults  # noqa: E402
from repro_torch.testing.parity import (assert_close,  # noqa: E402
                                        assert_ints_equal, margin_rows)
from tools.check_metrics import parse_exposition  # noqa: E402

M, D = 512, 32
LSS = LSSConfig(k_bits=4, n_tables=2)
T_OUT = 120.0


@pytest.fixture(autouse=True)
def _fault_hygiene():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # IUL trains here: one intra-op thread, as the trainer tests pin it
    # (eight OpenMP threads a worker under pytest -n 6 crawl)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w(seed=0):
    return np.random.default_rng(seed).standard_normal((M, D)).astype(
        np.float32)


def _calib():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((256, D)).astype(np.float32)
    labels = rng.integers(0, M, (256, 3)).astype(np.int32)
    return q, labels


def _engine(audit_rate=None):
    return Engine(None, torch.from_numpy(_w()), None, LSS, top_k=5,
                  head="lss", buckets=(8,), audit_rate=audit_rate)


def _fitted(audit_rate=None):
    eng = _engine(audit_rate=audit_rate)
    q, labels = _calib()
    eng.fit_from_queries(torch.Generator().manual_seed(1),
                         torch.from_numpy(q), torch.from_numpy(labels))
    return eng, q


def _sample(family, families):
    fam = families.get(family)
    assert fam is not None, f"{family} missing from exposition"
    return fam["samples"][0][2]


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a.logits), np.asarray(b.logits))
    np.testing.assert_array_equal(np.asarray(a.ids), np.asarray(b.ids))


# ------------------------------------------------------------- lifecycle --

def test_refresh_swaps_and_matches_cold_built_engine():
    """A refresh cycle swaps in a retrained index, and serving through
    the swapped engine is bit-identical to a COLD engine built directly
    on that index."""
    eng, q = _fitted()
    idx_before = eng.index
    r = IndexRefresher(eng, auditor=None, cfg=RefreshConfig())
    assert r.refresh_once() == "swapped"
    assert eng.index_epoch == 2
    assert eng.index is not idx_before
    assert not torch.equal(eng.index.theta, idx_before.theta)
    cold = _engine()
    cold._set_index(eng.index)
    _same(eng.rank(q[:8], record=False), cold.rank(q[:8]))
    # a second cycle continues the same training stream
    assert r.refresh_once() == "swapped"
    assert eng.index_epoch == 3 and r.n_refreshes == 2
    assert r.n_failed == 0 and r.last_error is None


def test_swap_drops_unpinned_and_keeps_pinned_epochs():
    eng, q = _fitted()
    e1 = eng.pin_epoch()
    idx1 = eng.index
    eng.swap_index(eng.index_for(e1))       # new epoch from same index
    assert eng.index_epoch == 2 and e1 in eng._epochs
    assert eng.index_for(e1) is idx1        # pinned epoch still readable
    eng.unpin_epoch(e1)
    assert e1 not in eng._epochs            # dropped once released
    with pytest.raises(KeyError):
        eng.index_for(e1)


def test_warm_epoch_builds_the_new_epochs_steps_before_the_flip():
    """``swap_index`` builds the new epoch's score steps for the buckets
    the serving epoch built, before it flips: the first post-swap chunk
    replays a built step."""
    eng, q = _fitted()
    eng.rank(q[:8], record=False)                    # builds (lss, 8)
    assert eng.compile_counts == {("lss", 8): 1}
    seen = {}
    real = eng._swap_prepared

    def flip(epoch):
        seen["built"] = set(eng._epochs[epoch].steps)
        seen["serving"] = eng.index_epoch
        return real(epoch)

    eng._swap_prepared = flip
    e = eng.swap_index(eng.index)
    assert seen == {"built": {("lss", 8)}, "serving": 1} and e == 2
    assert eng.compile_counts == {("lss", 8): 2}
    eng.rank(q[:8], record=False)
    assert eng.compile_counts == {("lss", 8): 2}     # no build after
    # an embed_fn engine cannot fabricate requests: nothing to warm
    emb = Engine(lambda b: b, torch.from_numpy(_w()), None, LSS, top_k=5,
                 buckets=(8,))
    emb.fit_random(torch.Generator().manual_seed(3))
    emb.rank(q[:8], record=False)
    emb.swap_index(emb.index)
    assert emb.compile_counts == {("lss", 8): 1}


def test_engine_swap_fault_fires_inside_the_swap():
    """``engine.swap`` fires inside the flip's critical section: an
    armed exception aborts the flip and the serving epoch stays."""
    eng, q = _fitted()
    before = eng.rank(q[:8], record=False)
    seen = []
    with faults.injected(faults.ENGINE_SWAP,
                         lambda ctx: seen.append(ctx["epoch"])):
        e = eng.swap_index(eng.index)
    assert seen == [e] and eng.index_epoch == e
    with faults.injected(faults.ENGINE_SWAP, RuntimeError("swap boom")):
        with pytest.raises(RuntimeError, match="swap boom"):
            eng.swap_index(eng.index)
    assert eng.index_epoch == e
    _same(eng.rank(q[:8], record=False), before)
    assert faults.fire_count(faults.ENGINE_SWAP) == 2


def test_swap_from_theta_rebuilds_the_same_index():
    eng, q = _fitted()
    cold = _engine()
    e = cold.swap_from_theta(eng.index.theta.numpy())
    assert cold.index_epoch == e == 1
    assert torch.equal(cold.index.tables.table_ids,
                       eng.index.tables.table_ids)
    _same(cold.rank(q[:8], record=False), eng.rank(q[:8], record=False))


def test_refit_failure_degrades_and_backs_off():
    """Injected refit failures leave the serving index untouched, count
    consecutively, back off exponentially, and park the loop at
    max_failures — never crash the serving path."""
    eng, q = _fitted()
    cfg = RefreshConfig(interval_s=0.01, max_failures=3,
                        backoff_base_s=0.01, backoff_max_s=0.05)
    r = IndexRefresher(eng, auditor=None, cfg=cfg)
    before = eng.index
    with faults.injected(faults.REFRESH_REFIT, RuntimeError("refit boom")):
        assert r.refresh_once() == "failed"
        assert r.n_failures == 1 and r._backoff() == 0.01
        assert r.refresh_once() == "failed"
        assert r.n_failures == 2 and r._backoff() == 0.02
    assert "refit boom" in r.last_error
    assert eng.index is before and eng.index_epoch == 1
    assert eng.rank(q[:8], record=False).ids.shape == (8, 5)
    # recovery resets the consecutive counter, not the total
    assert r.refresh_once() == "swapped" and r.n_failures == 0
    assert r.n_failed == 2 and r.last_error is None
    # the background loop parks after max_failures consecutive failures
    faults.arm(faults.REFRESH_REFIT, RuntimeError("still broken"))
    r.start()
    deadline = time.monotonic() + 30.0
    while not r.parked and time.monotonic() < deadline:
        time.sleep(0.01)
    assert r.parked and r.n_failures == cfg.max_failures
    r.close()
    assert eng.rank(q[:8], record=False).ids.shape == (8, 5)


def test_nan_theta_guard_keeps_serving_index():
    eng, q = _fitted()
    r = IndexRefresher(eng, auditor=None, cfg=RefreshConfig())
    assert r.refresh_once() == "swapped"          # seeds the IUL state
    epoch = eng.index_epoch

    def poison(ctx):
        r._state = r._state._replace(
            theta=torch.full_like(r._state.theta, float("nan")))

    with faults.injected(faults.REFRESH_REFIT, poison):
        assert r.refresh_once() == "failed"
    assert "FloatingPointError" in r.last_error
    assert eng.index_epoch == epoch
    assert torch.isfinite(eng.rank(q[:8], record=False).logits).all()


def test_calibration_snapshot_is_frozen():
    """The refresher copies the calibration set once: a caller who
    overwrites its tensors afterwards does not change the refit."""
    eng, q = _fitted()
    cq, clab = eng.calib
    r = IndexRefresher(eng, auditor=None, cfg=RefreshConfig())
    snap = r._q_aug.clone()
    cq.fill_(0.0)
    clab.fill_(0)
    assert torch.equal(r._q_aug, snap)
    assert r.refresh_once() == "swapped"


def test_refresh_config_from_env(monkeypatch):
    monkeypatch.setenv("REPRO_REFRESH_INTERVAL", "7.5")
    monkeypatch.setenv("REPRO_REFRESH_PROBATION", "1.25")
    monkeypatch.setenv("REPRO_REFRESH_ROLLBACK_DELTA", "0.2")
    cfg = RefreshConfig.from_env(warm=False)
    assert (cfg.interval_s, cfg.probation_s, cfg.rollback_delta,
            cfg.warm) == (7.5, 1.25, 0.2, False)
    assert cfg._asdict() == JRefreshConfig.from_env(warm=False)._asdict()
    monkeypatch.setenv("REPRO_REFRESH_INTERVAL", "")
    assert RefreshConfig.from_env().interval_s == RefreshConfig().interval_s


def test_refresher_needs_a_calibration_snapshot():
    eng = _engine()
    eng.fit_random(torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match="calibration snapshot"):
        IndexRefresher(eng, auditor=None)


# ---------------------------------------------- refit and build off the lock

def test_slow_refit_never_blocks_concurrent_rank():
    """Only the O(1) flip is under the engine lock, so a rank racing a
    (slow) refit completes in per-chunk time, never waits out the
    refit."""
    eng, q = _fitted()
    eng.rank(q[:8], record=False)                   # build the (lss, 8) step
    r = IndexRefresher(eng, auditor=None, cfg=RefreshConfig(warm=True))
    faults.arm(faults.REFRESH_REFIT, 1.5)           # refit sleeps 1.5 s
    out = {}
    th = threading.Thread(target=lambda: out.update(res=r.refresh_once()))
    th.start()
    worst, n = 0.0, 0
    while th.is_alive():
        t0 = time.perf_counter()
        eng.rank(q[:8], record=False)
        worst = max(worst, time.perf_counter() - t0)
        n += 1
    th.join(timeout=T_OUT)
    assert out["res"] == "swapped"
    assert n >= 3, f"only {n} ranks ran during a 1.5 s refit"
    assert worst < 0.75, \
        f"rank blocked {worst:.3f}s behind the refit — the refit is " \
        f"holding Engine.lock"


def test_step_build_holds_no_engine_lock():
    """A step's build holds only the step's own lock: while one thread
    builds a new epoch's step (here held open inside its body), another
    takes the engine lock at once (``submit``, ``_record``)."""
    eng, q = _fitted()
    e = eng.prepare_epoch(eng.index)
    step = eng._step("lss", 8, epoch=e)
    inside, release = threading.Event(), threading.Event()
    fn = step.fn

    def held(x):
        inside.set()
        release.wait(T_OUT)
        return fn(x)

    step.fn = held
    th = threading.Thread(target=lambda: step(q[:8]))
    th.start()
    try:
        assert inside.wait(T_OUT)
        got = eng.lock.acquire(timeout=5.0)
        assert got, "the engine lock is held across a step's build"
        eng.lock.release()
        assert eng.submit(q[0]) == 0
        assert eng.n_builds() == 1                # counted at build start
    finally:
        release.set()
        th.join(timeout=T_OUT)
    assert not th.is_alive()
    assert len(eng.flush()) == 1


# --------------------------------------------------- guarded rollback --

def test_corrupt_recall_triggers_rollback_within_probation():
    """An injected recall regression during probation rolls the engine
    back to the previous index (bit-identical serving restored) and
    raises ``lss_refresh_rollback_total``, with the auditor's
    ``lss_audit_recall_at_k`` gauge live."""
    eng, q = _fitted(audit_rate=1.0)
    for i in range(12):                             # pre-swap baseline
        eng.rank(q[8 * i:8 * i + 8])
    eng.auditor.drain()
    _, total0 = eng.auditor.snapshot()
    assert total0 > 0
    r = IndexRefresher(eng, cfg=RefreshConfig(
        probation_s=30.0, min_audit_rows=40, probation_poll_s=0.02))
    idx_before = eng.index
    ref_out = eng.rank(q[:8], record=False)

    stop = threading.Event()

    def traffic():                                  # feeds the auditor
        i = 0
        while not stop.is_set():
            eng.rank(q[8 * (i % 30):8 * (i % 30) + 8])
            i += 1
            time.sleep(0.005)

    th = threading.Thread(target=traffic, daemon=True)
    th.start()
    try:
        t0 = time.monotonic()
        with faults.injected(faults.REFRESH_PROBATION,
                             lambda ctx: ctx.__setitem__("recall", 0.0)):
            outcome = r.refresh_once()
        elapsed = time.monotonic() - t0
    finally:
        stop.set()
        th.join(timeout=T_OUT)
    assert outcome == "rolled_back" and r.n_rollbacks == 1
    assert elapsed < 30.0, "rollback decided by probation, not timeout"
    assert eng.index is idx_before                  # restored, new epoch
    assert eng.index_epoch == 3 and list(eng._epochs) == [3]
    _same(eng.rank(q[:8], record=False), ref_out)
    fams, errors = parse_exposition(prometheus_text())
    assert not errors, errors
    assert _sample("lss_refresh_rollback_total", fams) >= 1
    assert np.isfinite(_sample("lss_audit_recall_at_k", fams))
    eng.auditor.close()


def test_probation_passes_without_evidence():
    """No auditor rows inside the window is NOT evidence of regression:
    the swap stands."""
    eng, _ = _fitted(audit_rate=1.0)
    r = IndexRefresher(eng, cfg=RefreshConfig(probation_s=0.05,
                                              probation_poll_s=0.01,
                                              min_audit_rows=10 ** 6))
    assert r.refresh_once() == "swapped"
    assert eng.index_epoch == 2
    eng.auditor.close()


# ----------------------------------------------------- decode pinning --

VOCAB, PLEN = 256, 6
_LM_CACHE = []


def _lm_data():
    """Small LM shared by the decode tests (a cached helper, not a
    fixture: the hypothesis stub's ``@given`` erases the signature)."""
    if not _LM_CACHE:
        cfg = T.TransformerConfig(name="t", n_layers=1, d_model=32,
                                  n_heads=2, n_kv_heads=2, head_dim=16,
                                  d_ff=64, vocab=VOCAB, dtype=torch.float32,
                                  kv_chunk=32)
        params = T.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
        toks = lm_dataset(0, 64 * 33, VOCAB, 33)
        _LM_CACHE.append((params, cfg, toks))
    return _LM_CACHE[0]


@pytest.fixture(scope="module")
def lm():
    return _lm_data()


def _decoder(lm, fit_seed=1):
    params, cfg, _ = lm
    dec = LMDecoder(params, cfg, LSS, max_streams=2, max_len=16)
    dec.engine.fit_random(torch.Generator().manual_seed(fit_seed))
    return dec


def _alt_index(lm):
    """A second, different LSS index over the same decoder weights."""
    return _decoder(lm, fit_seed=9).engine.index


def test_swap_mid_decode_is_invisible_to_pinned_sessions(lm):
    """Sessions decode through the epoch their generation pinned: a swap
    mid-flight changes no token vs a no-swap run, and the NEXT generation
    serves the new index — bit-identical to a cold engine on it."""
    _, _, toks = lm
    budgets = [4, 7, 3, 6]
    idx2 = _alt_index(lm)

    ref = _decoder(lm)                              # never swapped
    sref = ref.scheduler(head="lss")
    ref_streams = [sref.submit(toks[i, :PLEN], max_new_tokens=budgets[i])
                   for i in range(4)]
    sref.run(timeout=T_OUT)

    dec = _decoder(lm)                              # swapped mid-decode
    sched = dec.scheduler(head="lss")
    streams = [sched.submit(toks[i, :PLEN], max_new_tokens=budgets[i])
               for i in range(4)]
    for _ in range(3):                              # sessions in flight
        sched.tick()
    assert sched.pool.n_active > 0
    e_old = sched._epoch
    e_new = dec.engine.swap_index(idx2)             # mid-decode swap
    assert dec.engine.index_epoch == e_new and e_old in dec.engine._epochs
    sched.run(timeout=T_OUT)
    for i, (st_new, st_ref) in enumerate(zip(streams, ref_streams)):
        np.testing.assert_array_equal(
            st_new.result(timeout=1.0), st_ref.result(timeout=1.0),
            err_msg=f"session {i} perturbed by the swap")
    # the drained generation released its pin: the old epoch is gone
    assert list(dec.engine._epochs) == [e_new]

    cold = _decoder(lm)                             # cold on the new index
    cold.engine._set_index(idx2)
    scold = cold.scheduler(head="lss")
    post = [sched.submit(toks[i, :PLEN], max_new_tokens=5)
            for i in range(3)]
    want = [scold.submit(toks[i, :PLEN], max_new_tokens=5)
            for i in range(3)]
    sched.run(timeout=T_OUT)
    scold.run(timeout=T_OUT)
    for i, (a, b) in enumerate(zip(post, want)):
        np.testing.assert_array_equal(a.result(timeout=1.0),
                                      b.result(timeout=1.0),
                                      err_msg=f"post-swap session {i}")
    # one fused step a generation: the new epoch's built once
    assert dec.engine.compile_counts[("lss", sched._tag)] == 2


_PROP_ENV: dict = {}


def _prop_env():
    """One decoder + scheduler + two reference decoders shared by every
    property example (each example drains the pool before the next)."""
    if not _PROP_ENV:
        lm = _lm_data()
        dec = _decoder(lm)
        idx1, idx2 = dec.engine.index, _alt_index(lm)
        ref1, ref2 = _decoder(lm), _decoder(lm)
        ref1.engine._set_index(idx1)
        ref2.engine._set_index(idx2)
        _PROP_ENV.update(lm=lm, dec=dec, sched=dec.scheduler(head="lss"),
                         idx1=idx1, idx2=idx2,
                         refs={id(idx1): ref1, id(idx2): ref2})
    return _PROP_ENV


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 2 ** 32 - 1))
def test_epoch_pinning_property_interleaved_ops(seed):
    """Seeded sweep over interleaved swap / join / leave / rank / tick
    sequences: every decode session's tokens are bit-identical to a
    no-swap run of the same epoch (blocking generate on a same-shaped
    decoder serving that session's pinned index)."""
    env = _prop_env()
    _, cfg, toks = env["lm"]
    dec, sched = env["dec"], env["sched"]
    idx1, idx2 = env["idx1"], env["idx2"]
    rng = np.random.default_rng(seed)
    sessions = []                   # [stream, prompt_row, budget, index]

    def record_pins():
        if sched._epoch is not None:
            pinned = dec.engine.index_for(sched._epoch)
            for s in sessions:
                if s[3] is None and s[0].ttft_s() is not None:
                    s[3] = pinned

    for _ in range(14):
        op = rng.choice(["join", "tick", "swap", "rank"],
                        p=[0.35, 0.4, 0.15, 0.1])
        if op == "join" and len(sessions) < 6:
            row = int(rng.integers(0, 32))
            budget = int(rng.integers(2, 5))
            stv = sched.submit(toks[row, :PLEN], max_new_tokens=budget)
            sessions.append([stv, row, budget, None])
        elif op == "swap":
            dec.engine.swap_index(
                idx2 if dec.engine.index is idx1 else idx1)
        elif op == "rank":
            x = rng.standard_normal((8, cfg.d_model)).astype(np.float32)
            dec.engine.rank(x, record=False)
        else:
            sched.tick()
        record_pins()
    while not sched.idle:                            # drain, still recording
        sched.tick()
        record_pins()
    sched.tick()                                     # collect the last step
    for stv, row, budget, pinned in sessions:
        assert stv.finish_reason == "max_tokens"
        assert pinned is not None
        ref = env["refs"][id(pinned)]
        want = ref.generate(toks[row:row + 1, :PLEN], steps=budget,
                            head="lss", timeout=T_OUT).numpy()[0]
        np.testing.assert_array_equal(stv.result(timeout=1.0), want)


# ----------------------------------- bounded runtime close, port release --

def test_metrics_port_released_after_close():
    """The /metrics listener releases its port on close(): a rebind on
    the SAME fixed port succeeds."""
    srv = MetricsServer(port=0)
    port = srv.port
    import urllib.request
    with urllib.request.urlopen(srv.url, timeout=5) as resp:
        assert resp.status == 200
    srv.close()
    assert not srv._thread.is_alive()
    srv2 = MetricsServer(port=port)                 # rebind proves release
    try:
        assert srv2.port == port
    finally:
        srv2.close()
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))


def test_runtime_exit_bounded_on_wedged_dispatcher():
    """A wedged dispatcher does not hang ``with AsyncRuntime(...)`` exit
    forever: ``close_timeout_s`` bounds the drain, the TimeoutError
    escapes, and the exporter can be shut down after."""
    eng, q = _fitted()
    eng.rank(q[:8], record=False)                   # build outside timing
    real_step = eng._step

    def wedged_step(kind, bucket, epoch=None):
        inner = real_step(kind, bucket, epoch)

        def slow(padded):
            time.sleep(3.0)
            return inner(padded)
        return slow

    eng._step = wedged_step
    srv = MetricsServer(port=0)
    t0 = time.monotonic()
    try:
        with pytest.raises(TimeoutError):
            with AsyncRuntime(eng, head="lss", policy="shed",
                              close_timeout_s=0.5) as rt:
                rt.submit(q[0])
                time.sleep(0.2)                     # let dispatch wedge
        assert time.monotonic() - t0 < 20.0
    finally:
        eng._step = real_step
        srv.close()
    assert not srv._thread.is_alive()


# ------------------------------------------------ parity with the JAX package

def test_swapped_engines_match_jax_engine():
    """A port engine and a JAX engine (``impl="ref"``) on the same weights,
    both swapped to the same hyperplanes — JAX's, after one refresh
    cycle, carried across through numpy — serve the same ids (exact on
    rows with hash margin > 1e-5) and logits within 1e-5."""
    w = _w()
    q, labels = _calib()
    jeng = JEngine(None, jnp.asarray(w), None, JLSSConfig(k_bits=4,
                                                          n_tables=2),
                   top_k=5, head="lss", buckets=(8,), impl="ref")
    jeng.fit_from_queries(jax.random.PRNGKey(1), jnp.asarray(q),
                          jnp.asarray(labels))
    jr = JIndexRefresher(jeng, auditor=None, cfg=JRefreshConfig())
    assert jr.refresh_once() == "swapped"
    theta = np.asarray(jeng.index.theta)
    assert jeng.swap_from_theta(theta) == 3
    teng = _engine()
    assert teng.swap_from_theta(tensor_from_numpy(theta, "cpu")) == 1
    assert_ints_equal(teng.index.tables.table_ids,
                      np.asarray(jeng.index.tables.table_ids),
                      what="table ids")
    xs = np.random.default_rng(4).standard_normal((64, D)).astype(
        np.float32)
    for i in range(0, 64, 8):
        jeng.submit_batch(jnp.asarray(xs[i:i + 8]))
        teng.submit_batch(xs[i:i + 8])
    jres, tres = jeng.flush(), teng.flush()
    j_ids = np.stack([r.ids for r in jres])
    t_ids = np.stack([r.ids for r in tres])
    aug = np.concatenate([xs, np.zeros((64, 1), np.float32)], 1)
    rows = margin_rows(aug, theta)
    assert rows.mean() > 0.9
    assert_ints_equal(t_ids, j_ids, rows=rows, what="ids")
    assert_close(np.stack([r.logits for r in tres]),
                 np.stack([r.logits for r in jres]), rtol=1e-5, atol=1e-5,
                 rows=rows, what="logits")


def _fault_script(f):
    """One arm/fire sequence through a faults module; returns what each
    fire did and the fire counts."""
    log = []

    def fire(point, **ctx):
        try:
            out = f.fire(point, **ctx)
            log.append((point, "ok", dict(out)))
        except Exception as exc:               # the armed exceptions
            log.append((point, "raised", f"{type(exc).__name__}:{exc}"))

    f.reset()
    fire(f.REFRESH_REFIT)                      # nothing armed: not counted
    f.arm(f.REFRESH_REFIT, RuntimeError("boom"), times=2)
    fire(f.REFRESH_REFIT)
    fire(f.REFRESH_BUILT, index="idx", recall=0.5)   # armed elsewhere
    fire(f.REFRESH_REFIT)
    fire(f.REFRESH_REFIT)                      # consumed: disarmed
    f.arm(f.REFRESH_PROBATION, lambda ctx: ctx.__setitem__("recall", 0.0))
    fire(f.REFRESH_PROBATION, recall=0.9, rows=64)
    with f.injected(f.ENGINE_SWAP, 0.0):
        fire(f.ENGINE_SWAP, epoch=3)
        armed_inside = f.armed(f.ENGINE_SWAP)
    f.arm(f.MULTIHOST_SWAP_COMMIT, ValueError, times=1)
    fire(f.MULTIHOST_SWAP_COMMIT)
    counts = {p: f.fire_count(p) for p in (
        f.REFRESH_REFIT, f.REFRESH_BUILT, f.REFRESH_PROBATION,
        f.ENGINE_SWAP, f.MULTIHOST_SWAP_COMMIT)}
    state = (armed_inside, f.armed(f.ENGINE_SWAP),
             f.armed(f.REFRESH_PROBATION), f.armed(f.MULTIHOST_SWAP_COMMIT))
    f.reset()
    return log, counts, state, f.fire_count(f.REFRESH_REFIT)


def test_fault_harness_matches_jax():
    got, want = _fault_script(faults), _fault_script(jfaults)
    assert got == want
    log, counts, state, after_reset = got
    assert counts == {"refresh.refit": 2, "refresh.built": 1,
                      "refresh.probation": 1, "engine.swap": 1,
                      "multihost.swap_commit": 1}
    assert [entry[1] for entry in log].count("raised") == 3
    assert state == (True, False, True, False) and after_reset == 0
