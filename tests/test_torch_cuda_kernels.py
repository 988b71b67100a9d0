"""The port's CUDA kernels against their plain versions, on the card,
the serving engine's steps captured as CUDA graphs (also while the
engine serves and swaps index epochs), and the decode scheduler's fused
step (a CUDA graph over the KV pool, updated in place).

These need a CUDA device and ``nvcc`` (the kernels build at first use) and
skip without one.  They import no JAX, so they run where only PyTorch is
installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.lss import LSSConfig, build_index  # noqa: E402
from repro_torch.core.simhash import (augment_neurons,  # noqa: E402
                                      augment_queries, unit)
from repro_torch.kernels.bucket_logits import bucket_logits  # noqa: E402
from repro_torch.kernels.bucket_logits.ops import (  # noqa: E402
    bucket_logits_cuda, bucket_logits_plan)
from repro_torch.kernels.bucket_logits.ref import bucket_logits_ref  # noqa: E402
from repro_torch.kernels.lss_topk import lss_topk  # noqa: E402
from repro_torch.kernels.lss_topk.ops import lss_topk_cuda  # noqa: E402
from repro_torch.kernels.lss_topk.ref import lss_topk_ref  # noqa: E402
from repro_torch.kernels.lss_topk.slabs import quantize_slabs  # noqa: E402
from repro_torch.kernels.simhash_codes import simhash_codes  # noqa: E402
from repro_torch.kernels.simhash_codes.ops import (  # noqa: E402
    simhash_codes_cuda, simhash_codes_plan)
from repro_torch.kernels.simhash_codes.ref import simhash_codes_ref  # noqa: E402
from repro_torch.testing.parity import (assert_close,  # noqa: E402
                                        assert_ints_equal,
                                        assert_topk_ids_equal, margin_rows)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("bsz,d,k_bits,n_tables",
                         [(37, 17, 4, 3), (1024, 129, 9, 1), (5, 129, 8, 4),
                          (1, 129, 9, 1), (256, 129, 9, 1),
                          (1000, 129, 8, 4)])   # 7 rows a block: 1000 % 7
def test_simhash_codes_kernel_matches_plain(cuda, bsz, d, k_bits, n_tables):
    if bsz == 1000:
        rows = simhash_codes_plan(bsz, d, k_bits, n_tables).rows
        assert rows == 7 and bsz % rows
    g = torch.Generator(cuda).manual_seed(bsz)
    x = unit(torch.randn(bsz, d, generator=g, device=cuda))
    theta = torch.randn(d, k_bits * n_tables, generator=g, device=cuda)
    before = simhash_codes_cuda.launches
    got = simhash_codes(x, theta, k_bits, n_tables)
    assert simhash_codes_cuda.launches == before + 1
    want = simhash_codes_ref(x, theta, k_bits, n_tables)
    torch.cuda.synchronize()
    assert_ints_equal(got, want, rows=margin_rows(x, theta), what="codes")


def _case(cuda, seed, bsz, d, k_bits, n_tables, cap, m):
    rng = np.random.default_rng(seed)
    q = augment_queries(torch.from_numpy(
        rng.normal(size=(bsz, d - 1)).astype(np.float32))).to(cuda)
    theta = torch.from_numpy(
        rng.normal(size=(d, k_bits * n_tables)).astype(np.float32)).to(cuda)
    nb = 2 ** k_bits
    tids = rng.integers(0, m, size=(n_tables, nb, cap)).astype(np.int32)
    tids[rng.random(tids.shape) < 0.25] = -1
    tids[:, 0] = -1                                   # empty buckets
    wb = rng.normal(size=(n_tables, nb, cap, d)).astype(np.float32)
    wb[tids < 0] = 0.0
    return q, theta, torch.from_numpy(tids).to(cuda), \
        torch.from_numpy(wb).to(cuda)


def _named_case(cuda, name, slab_dtype):
    """``(q, theta, table_ids, slabs, scales)`` of a named input."""
    rng = np.random.default_rng(7)
    if name == "tables":
        # an index built from real rows: each slab's occupied slots are a
        # prefix; d = 129 and P = 99 put int8 slab starts off 16 bytes
        d, k_bits, n_tables = 129, 4, 2
        w_aug = augment_neurons(
            torch.from_numpy(rng.normal(size=(1200, d - 1))
                             .astype(np.float32)).to(cuda),
            torch.zeros(1200, device=cuda))
        theta = torch.from_numpy(rng.normal(size=(d, k_bits * n_tables))
                                 .astype(np.float32)).to(cuda)
        idx = build_index(w_aug, theta, LSSConfig(
            k_bits=k_bits, n_tables=n_tables, capacity=99,
            slab_dtype=slab_dtype))
        q = augment_queries(torch.from_numpy(
            rng.normal(size=(64, d - 1)).astype(np.float32)).to(cuda))
        return (q, theta, idx.tables.table_ids, idx.w_bucketed,
                idx.w_scale)
    if name == "dedup16k":
        # tests/test_dedup.py's C = 16,384 shape: ids drawn from [-1, C/2),
        # every slot row random (an empty slot's logit is masked by id)
        bsz, d, k_bits, n_tables, cap = 4, 16, 2, 2, 8192
        tids = rng.integers(-1, n_tables * cap // 2,
                            size=(n_tables, 2 ** k_bits, cap))
    else:
        bsz, d, k_bits, n_tables, cap = 8, 33, 3, 2, 40
        shape = (n_tables, 2 ** k_bits, cap)
        tids = np.full(shape, 7 if name == "all_duplicate" else -1)
    q = augment_queries(torch.from_numpy(
        rng.normal(size=(bsz, d - 1)).astype(np.float32))).to(cuda)
    theta = torch.from_numpy(rng.normal(size=(d, k_bits * n_tables))
                             .astype(np.float32)).to(cuda)
    wb = torch.from_numpy(rng.normal(size=(*tids.shape, d))
                          .astype(np.float32)).to(cuda)
    w, scale = quantize_slabs(wb, slab_dtype)
    return (q, theta, torch.from_numpy(tids.astype(np.int32)).to(cuda), w,
            scale)


@pytest.mark.parametrize("slab_dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("shape", [(16, 17, 3, 2, 32, 50),       # C = 64
                                   (9, 33, 2, 3, 88, 150),       # C = 264
                                   (3, 129, 8, 4, 1608, 9000),   # C = 6432
                                   "dedup16k",                   # C = 16384
                                   "tables", "all_duplicate", "all_empty"])
def test_lss_topk_kernel_matches_plain(cuda, slab_dtype, shape):
    if isinstance(shape, str):
        q, theta, tids, w, scale = _named_case(cuda, shape, slab_dtype)
    else:
        q, theta, tids, wb = _case(cuda, 0, *shape)
        w, scale = quantize_slabs(wb, slab_dtype)
    c = tids.shape[0] * tids.shape[2]
    for top_k in sorted({5, c if c <= 264 else 5}):
        before = lss_topk_cuda.launches
        got = lss_topk(q, theta, tids, w, top_k=top_k, w_scale=scale)
        assert lss_topk_cuda.launches == before + 1
        want = lss_topk_ref(q, theta, tids, w, top_k=top_k, w_scale=scale)
        torch.cuda.synchronize()
        rows = margin_rows(q, theta)
        assert_ints_equal(got[3], want[3], rows=rows, what="cand")
        assert_ints_equal(got[2], want[2], rows=rows, what="sample")
        assert_close(got[0], want[0], rtol=1e-4, atol=1e-4, rows=rows,
                     what="top_logits")
        assert_topk_ids_equal(got[1], want[1], want[0], 1e-4, rows=rows,
                              what="top_ids")
    if shape == "all_duplicate":
        assert bool((got[2] == 1).all()) and bool((got[1][:, 0] == 7).all())
    if shape == "all_empty":
        assert bool((got[2] == 0).all()) and bool((got[1] == -1).all())


@pytest.mark.parametrize("q_dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("bsz,d,n_slabs,cap,n_tables",
                         [(7, 17, 5, 33, 3),          # d, P below a warp
                          (256, 129, 512, 808, 1),    # Delicious-200K
                          (1, 129, 512, 808, 1),      # one query
                          (3, 129, 1024, 1608, 4)])   # K = 8, L = 4
def test_bucket_logits_kernel_matches_plain(cuda, q_dtype, w_dtype, bsz, d,
                                            n_slabs, cap, n_tables):
    g = torch.Generator(cuda).manual_seed(bsz + d)
    q = torch.randn(bsz, d, generator=g, device=cuda).to(q_dtype)
    w = torch.randn(n_slabs, cap, d, generator=g, device=cuda).to(w_dtype)
    w[:, cap // 2] = 0                                # an empty slot
    ids = torch.randint(0, n_slabs, (bsz, n_tables), generator=g,
                        device=cuda, dtype=torch.int32)
    before = bucket_logits_cuda.launches
    got = bucket_logits(q, w, ids)
    assert bucket_logits_cuda.launches == before + 1
    want = bucket_logits_ref(q, w, ids)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    # both widen the same bf16 bits to fp32; the sums' orders differ
    assert_close(got, want, rtol=1e-4, atol=1e-4, what="bucket_logits")
    assert bool((got[:, :, cap // 2] == 0).all())
    # an id outside [0, S) reads nothing and gives NaN for its (b, l)
    bad = ids.clone()
    bad[0, 0] = n_slabs
    out = bucket_logits(q, w, bad)
    torch.cuda.synchronize()
    assert bool(out[0, 0].isnan().all())
    assert torch.equal(out.reshape(-1, cap)[1:], got.reshape(-1, cap)[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bucket_logits_one_slab_for_every_query(cuda, dtype):
    """256 queries on one Delicious-200K slab: every block of the grid
    reads the same rows."""
    g = torch.Generator(cuda).manual_seed(11)
    q = torch.randn(256, 129, generator=g, device=cuda)
    w = torch.randn(64, 808, 129, generator=g, device=cuda).to(dtype)
    ids = torch.full((256, 1), 37, dtype=torch.int32, device=cuda)
    got = bucket_logits(q, w, ids)
    want = bucket_logits_ref(q, w, ids)
    torch.cuda.synchronize()
    assert got.shape == (256, 1, 808)
    assert_close(got, want, rtol=1e-4, atol=1e-4, what="bucket_logits")


@pytest.mark.parametrize("d", [129, 17])
def test_bucket_logits_bf16_slabs_off_16_bytes(cuda, d):
    """bf16 slabs whose data_ptr is 2 bytes past an aligned address: every
    bulk copy is rounded out to 16 B at both ends and read at its offset."""
    n_slabs, cap, bsz = 6, 45, 9
    g = torch.Generator(cuda).manual_seed(d)
    base = torch.randn(n_slabs * cap * d + 1, generator=g,
                       device=cuda).bfloat16()
    w = base[1:].view(n_slabs, cap, d)
    assert w.data_ptr() % 16 == 2
    q = torch.randn(bsz, d, generator=g, device=cuda)
    ids = torch.randint(0, n_slabs, (bsz, 2), generator=g, device=cuda,
                        dtype=torch.int32)
    plan = bucket_logits_plan(bsz, 2, cap, d, torch.bfloat16)
    assert plan.rows < cap                 # several copies a slab
    got = bucket_logits(q, w, ids)
    want = bucket_logits_ref(q, w, ids)
    torch.cuda.synchronize()
    assert_close(got, want, rtol=1e-4, atol=1e-4, what="bucket_logits")


# ------------------------------------------- the engine's CUDA-graph steps --

def _serving_engine(cuda, buckets=(8,)):
    from repro_torch.serve import Engine
    g = torch.Generator(cuda).manual_seed(3)
    w = torch.randn(4096, 32, generator=g, device=cuda)
    eng = Engine(None, w, None, LSSConfig(k_bits=5, n_tables=2), top_k=5,
                 head="lss", buckets=buckets)
    eng.fit_random(g)
    return eng


@pytest.mark.parametrize("kind", ["lss", "full"])
def test_captured_step_equals_eager_step(cuda, kind):
    """A (head, bucket) step replayed from its CUDA graph gives the bits
    of the same step run eagerly.  The lss_topk wrapper counts the build's
    two launches (the warm-up's and the one captured) and no replay; the
    profiler sees one lss_topk kernel on the device a replay."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng = _serving_engine(cuda)
    x = torch.randn(8, 32, generator=torch.Generator(cuda).manual_seed(4),
                    device=cuda)
    step = eng._step(kind, 8)
    with torch.no_grad():
        eager = step.fn(x)
    per_call = 1 if kind == "lss" else 0
    before = lss_topk_cuda.launches
    first = step(x)                         # warm-up, capture, replay
    assert step.captured and eng.compile_counts[(kind, 8)] == 1
    assert lss_topk_cuda.launches - before == 2 * per_call
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = [step(x.cpu().numpy()) for _ in range(3)]
        torch.cuda.synchronize()
    assert lss_topk_cuda.launches - before == 2 * per_call
    kernels = sum(1 for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and "lss_topk" in e.name)
    assert kernels == 3 * per_call
    for out in (first, *again):
        for got, want in zip(out, eager):
            if want is not None:
                assert torch.equal(got, want)
    assert eng.compile_counts[(kind, 8)] == 1


def test_capture_pauses_the_collector(cuda):
    """No automatic garbage collection inside a capture: a collection
    there could destroy a dead engine's graph (an engine and its steps
    form a reference cycle), which this thread may not do while it
    captures, and which invalidates the capture."""
    import gc
    eng = _serving_engine(cuda)
    step = eng._step("lss", 8)
    x = torch.randn(8, 32, generator=torch.Generator(cuda).manual_seed(6),
                    device=cuda)
    fn, seen = step.fn, []

    def watched(x):
        seen.append(gc.isenabled())
        return fn(x)

    step.fn = watched
    assert gc.isenabled()
    step(x)                                 # warm-up, then capture
    assert step.captured and seen == [True, False] and gc.isenabled()


def test_two_threads_replaying_one_step_get_their_own_rows(cuda):
    import threading
    eng = _serving_engine(cuda)
    step = eng._step("lss", 8)
    g = torch.Generator(cuda).manual_seed(5)
    xs = [torch.randn(8, 32, generator=g, device=cuda) for _ in range(2)]
    with torch.no_grad():
        want = [step.fn(x) for x in xs]
    step(xs[0])                             # capture once
    got = [[], []]

    def replay(i):
        for _ in range(50):
            got[i].append(step(xs[i].cpu().numpy()))

    threads = [threading.Thread(target=replay, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    for i in range(2):
        assert len(got[i]) == 50
        for out in got[i]:
            assert torch.equal(out.ids, want[i].ids)
            assert torch.equal(out.logits, want[i].logits)


# ------------------------------------- the swap path: builds while serving --

def _other_index(eng, seed):
    from repro_torch.core.simhash import init_hyperplanes
    theta = init_hyperplanes(torch.Generator(eng.device).manual_seed(seed),
                             eng._w_aug.shape[1], eng.lss_cfg.k_bits,
                             eng.lss_cfg.n_tables, device=eng.device)
    return build_index(eng._w_aug, theta, eng.lss_cfg)


def test_warm_capture_holds_no_engine_lock(cuda):
    """``warm_epoch`` captures the new epoch's step while one thread
    replays the serving step and another records chunks through
    ``Engine._record`` (the runtime's completion thread): both go on
    during the capture, which holds no engine lock, and the captured
    step replays the eager step's bits."""
    import threading
    import time

    from repro_torch.device import HostOutput
    eng = _serving_engine(cuda)
    g = torch.Generator(cuda).manual_seed(7)
    x = torch.randn(8, 32, generator=g, device=cuda)
    serving = eng._step("lss", 8)
    serving(x)                                       # built and captured
    e = eng.prepare_epoch(_other_index(eng, 8))
    new = eng._step("lss", 8, epoch=e)
    fn, calls = new.fn, []
    stop = threading.Event()
    counts = {"replays": 0, "records": 0}

    def held(xx):
        calls.append(torch.cuda.is_current_stream_capturing())
        if calls[-1]:                 # inside the capture: both go on
            n0 = dict(counts)
            deadline = time.monotonic() + 60.0
            while (any(counts[k] == n0[k] for k in counts)
                   and time.monotonic() < deadline):
                time.sleep(0.001)
            calls.append(all(counts[k] > n0[k] for k in counts))
        return fn(xx)

    new.fn = held
    host = HostOutput(serving(x)).wait()

    def replayer():
        while not stop.is_set():
            serving(x)
            counts["replays"] += 1

    def recorder():
        while not stop.is_set():
            eng._record(host, 8, 1e-3, [1e-3] * 8, None)
            counts["records"] += 1
            time.sleep(0.001)

    threads = [threading.Thread(target=f) for f in (replayer, recorder)]
    for t in threads:
        t.start()
    try:
        eng.warm_epoch(e)                            # captures `new`
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads)
    # warm-up, capture, and replays and records made during the capture
    assert calls == [False, True, True]
    assert new.captured and eng.compile_counts[("lss", 8)] == 2
    with torch.no_grad():
        want = fn(x)
    got = new(x)
    torch.cuda.synchronize()
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.logits, want.logits)


def test_epoch_dropped_during_a_capture(cuda):
    """One thread drops an epoch whose steps hold captured graphs while
    another captures: the graphs wait in ``step._DEAD`` until the
    capture ends (a graph destroyed inside another thread's capture
    invalidates it), then are destroyed, and the capture is valid."""
    import threading
    import time

    from repro_torch.serve import step as step_mod
    eng = _serving_engine(cuda)
    x = torch.randn(8, 32, generator=torch.Generator(cuda).manual_seed(9),
                    device=cuda)
    eng._step("lss", 8)(x)                           # epoch 1's graph
    e3 = eng.prepare_epoch(_other_index(eng, 10))
    eng.pin_epoch(e3)                                # kept by the swap
    e2 = eng.prepare_epoch(_other_index(eng, 11))
    new = eng._step("lss", 8, epoch=e3)
    fn = new.fn
    inside, dropped = threading.Event(), threading.Event()

    def held(xx):
        if torch.cuda.is_current_stream_capturing():
            inside.set()
            assert dropped.wait(60.0)
        return fn(xx)

    new.fn = held
    capture = threading.Thread(target=lambda: new(x))
    capture.start()
    assert inside.wait(60.0)
    dead0 = len(step_mod._DEAD)
    swap = threading.Thread(target=lambda: eng._swap_prepared(e2))
    swap.start()                                     # drops epoch 1
    deadline = time.monotonic() + 60.0
    while len(step_mod._DEAD) == dead0 and time.monotonic() < deadline:
        time.sleep(0.001)
    assert len(step_mod._DEAD) > dead0, "no graph was handed over"
    assert swap.is_alive()                           # waits on the capture
    dropped.set()
    capture.join(timeout=60.0)
    swap.join(timeout=60.0)
    assert not capture.is_alive() and not swap.is_alive()
    assert step_mod._DEAD == [] and set(eng._epochs) == {e2, e3}
    with torch.no_grad():
        want = fn(x)
    got = new(x)
    torch.cuda.synchronize()
    assert new.captured
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.logits, want.logits)


def test_swap_index_under_a_running_runtime(cuda):
    """Three ``swap_index`` calls while an ``AsyncRuntime`` serves an open
    loop: no future fails, each result is bit for bit a cold engine's on
    one of the indexes, and afterwards the engine serves a cold engine's
    results on the last one."""
    import threading
    import time

    from repro_torch.serve import AsyncRuntime, Engine
    from repro_torch.serve.runtime import submit_open_loop
    eng = _serving_engine(cuda, buckets=(1, 2, 4, 8, 16))
    for b in eng.batcher.buckets:
        eng._step("lss", b)(np.zeros((b, 32), np.float32))
    indexes = [eng.index] + [_other_index(eng, 20 + i) for i in range(3)]
    xs = np.random.default_rng(12).standard_normal((3000, 32)).astype(
        np.float32)

    def swapper():
        for idx in indexes[1:]:
            time.sleep(0.25)
            eng.swap_index(idx)

    rt = AsyncRuntime(eng, head="lss", max_queue=4000, policy="block")
    th = threading.Thread(target=swapper)
    th.start()
    futs, _ = submit_open_loop(rt, xs, 3000.0, seed=1)
    rt.drain(timeout=300.0)
    th.join(timeout=300.0)
    rt.close(timeout=60.0)
    assert not th.is_alive() and eng.index is indexes[-1]
    assert sum(f.exception(timeout=1.0) is not None for f in futs) == 0
    res = [f.result(timeout=1.0) for f in futs]
    colds = []
    for idx in indexes:
        cold = Engine(None, eng.w, None, eng.lss_cfg, top_k=5, head="lss",
                      buckets=(16,))
        cold._set_index(idx)
        out = cold.rank(xs, record=False)
        colds.append((out.logits.cpu().numpy(), out.ids.cpu().numpy()))
    for i, r in enumerate(res):
        assert any(np.array_equal(r.logits, lg[i]) and
                   np.array_equal(r.ids, ids[i]) for lg, ids in colds), i
    after = eng.rank(xs[:256], record=False)
    assert np.array_equal(after.logits.cpu().numpy(), colds[-1][0][:256])
    assert np.array_equal(after.ids.cpu().numpy(), colds[-1][1][:256])
    assert list(eng._epochs) == [eng.index_epoch]


# ------------------------------------------------ the decode step's graph --

def _decoder(cuda, layout, max_streams=4, max_len=64, lss=True):
    from repro_torch.models import transformer as T
    from repro_torch.serve import LMDecoder
    cfg = T.TransformerConfig(name="gpu-decode", n_layers=2, d_model=64,
                              n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                              vocab=4096, qkv_bias=True, tie_embeddings=True,
                              dtype=torch.bfloat16, kv_chunk=32)
    params = T.init_params(torch.Generator(cuda).manual_seed(0), cfg,
                           device=cuda)
    dec = LMDecoder(params, cfg, LSSConfig(k_bits=6, n_tables=1),
                    max_streams=max_streams, max_len=max_len,
                    kv_layout=layout, kv_page_tokens=16)
    if lss:
        dec.engine.fit_random(torch.Generator(cuda).manual_seed(1))
    return dec


def _prompts(n, vocab=4096, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(5, 30))).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("head", ["lss", "full"])
def test_decode_step_replay_equals_eager_step(cuda, layout, head):
    """A replay of the fused decode step gives the bits of the same step
    run eagerly on copies of its inputs.  The lss_topk wrapper counts the
    step's warm-up and capture (and the first-token step's) and no
    replay; the profiler sees one lss_topk kernel on the device a
    replay."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dec = _decoder(cuda, layout)
    sched = dec.scheduler(head=head)
    for p in _prompts(4):
        sched.submit(p, max_new_tokens=20)
    before = lss_topk_cuda.launches
    sched.tick()                            # 4 joins, step 1 (capture)
    per = 1 if head == "lss" else 0
    assert lss_topk_cuda.launches - before == 4 * per
    assert sched.decode_step().captured
    ops = sched.pool.step_operands()
    snap = [sched.tok.clone(), ops[0].clone(), ops[1].clone(),
            *(torch.from_numpy(o).to(cuda) for o in ops[2:])]
    sched.tick()                            # step 2, replayed
    got_hidden, got = sched._inflight.out
    with torch.no_grad():
        want_hidden, want = sched.decode_step().fn(dec.params, *snap)
    torch.cuda.synchronize()
    assert torch.equal(got_hidden, want_hidden)
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.logits, want.logits)
    assert torch.equal(snap[0], sched.tok)  # the same next tokens
    before = lss_topk_cuda.launches         # (the eager step launched too)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            sched.tick()
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and "lss_topk" in e.name)
    assert kernels == 3 * per
    assert lss_topk_cuda.launches == before  # replays call no wrapper
    sched.run(timeout=120.0)


@pytest.mark.parametrize("head", ["lss", "full"])
def test_inplace_kv_under_the_pipeline_with_slots_rejoining(cuda, head):
    """Six sessions with staggered budgets through two slots: each freed
    slot is rejoined while the previous step is still in flight, and the
    KV is written in place by the graph and by the joins.  The tokens are
    those of one-at-a-time blocking generate, and the paged layout's are
    the dense layout's."""
    prompts = _prompts(6, seed=3)
    budgets = [3, 9, 5, 12, 4, 7]
    runs = {}
    for layout in ("dense", "paged"):
        dec = _decoder(cuda, layout, max_streams=2)
        seq = [dec.generate(p[None], steps=b, head=head,
                            timeout=120.0).numpy()[0]
               for p, b in zip(prompts, budgets)]
        sched = dec.scheduler(head=head)
        streams = [sched.submit(p, max_new_tokens=b)
                   for p, b in zip(prompts, budgets)]
        sched.run(timeout=120.0)
        for i, st in enumerate(streams):
            np.testing.assert_array_equal(st.result(timeout=5.0), seq[i],
                                          err_msg=f"{layout} session {i}")
        assert dec.engine.compile_counts[(head, sched._tag)] == 1
        runs[layout] = seq
    for a, b in zip(runs["dense"], runs["paged"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_pool_growth_drops_the_outgrown_graph(cuda, layout):
    """A decoder sized at its first ``generate`` (``max_len=None``) and
    grown by a longer one: the outgrown step, whose graph holds the old
    pool's slabs, leaves the engine's table, the grown step is captured
    over the new pool, and its tokens are those of a decoder built at
    that width."""
    rng = np.random.default_rng(4)
    short = rng.integers(0, 4096, 20).astype(np.int32)[None]
    long = rng.integers(0, 4096, 60).astype(np.int32)[None]
    dec = _decoder(cuda, layout, max_len=None)
    dec.generate(short, steps=8, head="lss", timeout=120.0)
    small = dec.scheduler("lss")
    assert small.max_len == 64 and small.decode_step().captured
    got = dec.generate(long, steps=10, head="lss", timeout=120.0).numpy()
    grown = dec.scheduler("lss")
    table = dec.engine._epoch_state().steps
    assert grown.max_len == 70 and ("lss", small._tag) not in table
    assert table[("lss", grown._tag)].captured
    want = _decoder(cuda, layout, max_len=70).generate(
        long, steps=10, head="lss", timeout=120.0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bsz", [1, 8])
def test_lss_topk_at_the_decode_shape(cuda, bsz):
    """Qwen2-0.5B's decode head: d = 896 + 1, K = 10, L = 1, P = 304 (a
    slab row of 3,588 B, not a multiple of 16), on a random index."""
    d, k_bits, n_tables, cap, m = 897, 10, 1, 304, 151936
    g = torch.Generator(cuda).manual_seed(11)
    q = augment_queries(torch.randn(bsz, d - 1, generator=g, device=cuda))
    theta = torch.randn(d, k_bits * n_tables, generator=g, device=cuda)
    tids = torch.randint(-1, m, (n_tables, 2 ** k_bits, cap), generator=g,
                         device=cuda, dtype=torch.int32)
    wb = torch.randn(n_tables, 2 ** k_bits, cap, d, generator=g,
                     device=cuda)
    wb[tids < 0] = 0.0
    before = lss_topk_cuda.launches
    got = lss_topk(q, theta, tids, wb, top_k=1)
    assert lss_topk_cuda.launches == before + 1
    want = lss_topk_ref(q, theta, tids, wb, top_k=2)
    torch.cuda.synchronize()
    rows = margin_rows(q, theta)
    assert_ints_equal(got[3], want[3], rows=rows, what="cand")
    assert_ints_equal(got[2], want[2], rows=rows, what="sample")
    assert_close(got[0], want[0][:, :1], rtol=1e-4, atol=1e-4, rows=rows,
                 what="top_logits")
    assert_topk_ids_equal(got[1], want[1][:, :1], want[0][:, :1], 1e-4,
                          rows=rows, next_logit=want[0][:, 1],
                          what="top_ids")


# --------------------------------------------- every registry LM width --

# (d_aug, K, L, P) of each registry LM's LSS head (d_model + 1), the serve
# launcher's K = 6 index at qwen2-7b's width, and bert4rec's item head
LM_WIDTHS = [(897, 10, 1, 304), (2049, 10, 1, 304), (2561, 10, 1, 304),
             (3585, 10, 1, 304), (7169, 8, 1, 256), (3585, 6, 1, 4752),
             (65, 12, 1, 496)]


@pytest.mark.parametrize("slab_dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("shape", LM_WIDTHS)
def test_lss_topk_at_every_lm_width(cuda, shape, slab_dtype):
    """Narrow where q, theta and the rings fit in a block, wide where they
    do not (qwen3-4b, qwen2-7b and arctic-480b's widths): the kernel
    agrees with its plain version at the decode batch and at one row."""
    from repro_torch.kernels.lss_topk.ops import lss_topk_layout
    d, k_bits, n_tables, cap = shape
    g = torch.Generator(cuda).manual_seed(d + k_bits)
    q = augment_queries(torch.randn(8, d - 1, generator=g, device=cuda))
    theta = torch.randn(d, k_bits * n_tables, generator=g, device=cuda)
    tids = torch.randint(-1, 150_000, (n_tables, 2 ** k_bits, cap),
                         generator=g, device=cuda, dtype=torch.int32)
    wb = torch.randn(n_tables, 2 ** k_bits, cap, d, generator=g,
                     device=cuda)
    wb[tids < 0] = 0.0
    w, scale = quantize_slabs(wb, slab_dtype)
    del wb
    lay = lss_topk_layout(d, k_bits, n_tables, cap, slab_dtype)
    assert lay.smem <= 232_448
    for bsz in (8, 1):
        before = lss_topk_cuda.launches
        got = lss_topk(q[:bsz], theta, tids, w, top_k=5, w_scale=scale)
        assert lss_topk_cuda.launches == before + 1
        want = lss_topk_ref(q[:bsz], theta, tids, w, top_k=6, w_scale=scale)
        torch.cuda.synchronize()
        rows = margin_rows(q[:bsz], theta)
        assert_ints_equal(got[3], want[3], rows=rows, what="cand")
        assert_ints_equal(got[2], want[2], rows=rows, what="sample")
        assert_close(got[0], want[0][:, :5], rtol=1e-4, atol=1e-4,
                     rows=rows, what="top_logits")
        assert_topk_ids_equal(got[1], want[1][:, :5], want[0][:, :5], 1e-4,
                              rows=rows, next_logit=want[0][:, 5],
                              what="top_ids")


@pytest.mark.parametrize("bsz", [1, 256, 4096])
@pytest.mark.parametrize("shape", LM_WIDTHS)
def test_simhash_codes_at_every_lm_width(cuda, shape, bsz):
    """Whole or in d-tiles (d = 7,169, and d = 3,585 at 8 rows a block):
    the codes equal the plain version's on every margin row."""
    d, k_bits, n_tables, _ = shape
    g = torch.Generator(cuda).manual_seed(bsz + d)
    x = unit(torch.randn(bsz, d, generator=g, device=cuda))
    theta = torch.randn(d, k_bits * n_tables, generator=g, device=cuda)
    before = simhash_codes_cuda.launches
    got = simhash_codes(x, theta, k_bits, n_tables)
    assert simhash_codes_cuda.launches == before + 1
    want = simhash_codes_ref(x, theta, k_bits, n_tables)
    torch.cuda.synchronize()
    assert_ints_equal(got, want, rows=margin_rows(x, theta), what="codes")


# ------------------------------------------------ vocab-sharded serving --

@pytest.mark.parametrize("slab_dtype", ["fp32", "int8"])
def test_lss_topk_on_padded_shards(cuda, slab_dtype):
    """``shard_index`` of 4,099 rows into 4 shards: the last holds 1,024
    real rows and one padded (masked) slot.  Each shard's kernel agrees
    with its plain version, and no padded id is retrieved or returned."""
    from repro_torch.serve.heads import shard_index
    rng = np.random.default_rng(11)
    m, n_shards, d = 4099, 4, 33
    w_aug = augment_neurons(torch.from_numpy(
        rng.normal(size=(m, d - 1)).astype(np.float32)).to(cuda))
    theta = torch.from_numpy(
        rng.normal(size=(d, 8)).astype(np.float32)).to(cuda)
    q = augment_queries(torch.from_numpy(
        rng.normal(size=(64, d - 1)).astype(np.float32)).to(cuda))
    stack, _, m_local = shard_index(
        w_aug, theta, LSSConfig(k_bits=8, n_tables=1, slab_dtype=slab_dtype),
        n_shards)
    assert m_local == 1025
    rows = margin_rows(q, theta)
    for s, idx in enumerate(stack):
        t = idx.tables
        n_valid = min(m - s * m_local, m_local)
        got = lss_topk(q, theta, t.table_ids, idx.w_bucketed, top_k=5,
                       w_scale=idx.w_scale)
        want = lss_topk_ref(q, theta, t.table_ids, idx.w_bucketed, top_k=5,
                            w_scale=idx.w_scale)
        torch.cuda.synchronize()
        assert_ints_equal(got[3], want[3], rows=rows, what="cand")
        assert_ints_equal(got[2], want[2], rows=rows, what="sample")
        assert_close(got[0], want[0], rtol=1e-4, atol=1e-4, rows=rows,
                     what="top_logits")
        assert_topk_ids_equal(got[1], want[1], want[0], 1e-4, rows=rows,
                              what="top_ids")
        assert int(got[3].max()) < n_valid and int(got[1].max()) < n_valid


def test_world_one_sharded_step_is_captured(cuda, tmp_path):
    """``Engine(head="lss-sharded")`` on a one-rank NCCL group: its step
    is a CUDA graph ending at the shard's winners (the NCCL gather and
    the merge run after the replay), and its results are the ``lss``
    head's bits."""
    import torch.distributed as dist
    from repro_torch.distributed import init_distributed, shutdown_distributed
    assert init_distributed(store=dist.FileStore(str(tmp_path / "s"), 1),
                            num_processes=1, process_id=0)
    try:
        eng = _serving_engine(cuda)
        mesh = eng._get_mesh()
        assert mesh.backend == "nccl" and mesh.group is not None
        x = torch.randn(8, 32, generator=torch.Generator(cuda).manual_seed(4),
                        device=cuda)
        sharded = eng._step("lss-sharded", 8)
        before = lss_topk_cuda.launches
        outs = [sharded(x) for _ in range(3)]
        assert sharded.captured and lss_topk_cuda.launches - before == 2
        want = eng._step("lss", 8)(x)
        for out in outs:
            for got, ref in zip(out[:3], want[:3]):
                assert got.dtype == ref.dtype and torch.equal(got, ref)
            assert out.cand_ids is None
    finally:
        shutdown_distributed()


# ----------------------------------------------------- sharded training --

_TRAIN_WORKER = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.data.pipeline import ShardedBatchIterator
from repro_torch.data.synthetic import xc_dataset
from repro_torch.distributed import (init_distributed, make_training_mesh,
                                     shutdown_distributed)
from repro_torch.models import xc
from repro_torch.train.trainer import TrainConfig, Trainer
from repro_torch.utils.sharding import full_tensor

d, rank = sys.argv[1], int(sys.argv[2])
assert init_distributed(None, 2, rank, timeout_s=120,
                        store=dist.FileStore(os.path.join(d, "store"), 2))
tm = make_training_mesh((1, 2))
assert tm.backend == "gloo" and tm.device.type == "cuda", tm
cfg = xc.XCConfig("t", input_dim=3000, hidden=32, output_dim=4099,
                  max_in=16, max_labels=4)
data = xc_dataset(3, 512, cfg.input_dim, cfg.output_dim, n_topics=16,
                  max_in=cfg.max_in, max_labels=cfg.max_labels)
tr = Trainer(lambda p, b: xc.loss(p, b, cfg),
             lambda g: xc.init_params(g, cfg, tm.device),
             TrainConfig(lr=5e-3, warmup_steps=0, total_steps=10),
             mesh=tm.mesh, param_specs=xc.param_specs(cfg))
state, _ = tr.fit(torch.Generator(tm.device).manual_seed(0),
                  ShardedBatchIterator({"x": data.x, "labels": data.labels},
                                       64, mesh=tm.mesh), 4, log_every=4)
w, b = state.params["w_out"], state.params["b_out"]
full_w, full_b = full_tensor(w), full_tensor(b)    # staged through the host
np.savez(os.path.join(d, f"shard{rank}.npz"), w=w.to_local().cpu().numpy(),
         b=b.to_local().cpu().numpy(), full_w=full_w.cpu().numpy(),
         full_b=full_b.cpu().numpy())
shutdown_distributed(timeout_s=120)
"""


def test_lss_topk_on_a_shard_trained_on_1x2(cuda, tmp_path):
    """Two processes share the card over gloo and train the XC model on a
    (1, 2) mesh; each keeps its half of the WOL rows.  Each half is the
    matching rows of the gathered WOL (the gather staged through the
    host), and the index of each rank's own rows (``shard_index`` with
    its shard range) runs ``lss_topk`` as its plain version does."""
    import os
    import subprocess
    import sys
    from repro_torch.serve.heads import shard_index
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _TRAIN_WORKER,
                               str(tmp_path), str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    z = [np.load(tmp_path / f"shard{r}.npz") for r in range(2)]
    m, m_local = z[0]["full_w"].shape[0], z[0]["w"].shape[0]
    assert (m, m_local, z[1]["w"].shape[0]) == (4099, 2050, 2049)
    for r in range(2):
        np.testing.assert_array_equal(z[r]["full_w"], z[0]["full_w"])
        np.testing.assert_array_equal(
            z[r]["w"], z[0]["full_w"][r * m_local:(r + 1) * m_local])
    rng = np.random.default_rng(5)
    theta = torch.from_numpy(rng.normal(size=(33, 8)).astype(
        np.float32)).to(cuda)
    q = augment_queries(torch.from_numpy(
        rng.normal(size=(64, 32)).astype(np.float32))).to(cuda)
    rows = margin_rows(q, theta)
    for r in range(2):
        w_aug = augment_neurons(torch.from_numpy(z[r]["w"]).to(cuda),
                                torch.from_numpy(z[r]["b"]).to(cuda))
        (idx,), _, ml = shard_index(w_aug, theta,
                                    LSSConfig(k_bits=8, n_tables=1), 2,
                                    shard_range=(r, r + 1), m_total=m)
        assert ml == m_local
        t = idx.tables
        before = lss_topk_cuda.launches
        got = lss_topk(q, theta, t.table_ids, idx.w_bucketed, top_k=5)
        assert lss_topk_cuda.launches == before + 1
        want = lss_topk_ref(q, theta, t.table_ids, idx.w_bucketed, top_k=5)
        torch.cuda.synchronize()
        assert_ints_equal(got[3], want[3], rows=rows, what="cand")
        assert_close(got[0], want[0], rtol=1e-4, atol=1e-4, rows=rows,
                     what="top_logits")
        assert_topk_ids_equal(got[1], want[1], want[0], 1e-4, rows=rows,
                              what="top_ids")
        assert int(got[1].max()) < (m_local if r == 0 else m - m_local)


# ---------------------------------------- the kernels as dispatcher ops --

def _custom_op_cases(cuda):
    """Each kernel's arguments at a small shape, and its launch function
    (the ``ctypes`` launch the op's CUDA kernel calls)."""
    q, theta, tids, wb = _case(cuda, 5, 64, 33, 6, 3, 24, 5000)
    slabs = wb.reshape(-1, 24, 33)
    slab_ids = torch.randint(0, slabs.shape[0], (64, 3), device=cuda,
                             dtype=torch.int32)
    return {
        "lss_topk": ((q, theta, tids, wb), {"top_k": 7},
                     lambda: lss_topk_cuda(q, theta, tids, wb, top_k=7),
                     lss_topk_cuda),
        "simhash_codes": ((unit(q), theta, 6, 3), {},
                          lambda: simhash_codes_cuda(unit(q), theta, 6, 3),
                          simhash_codes_cuda),
        "bucket_logits": ((q, slabs, slab_ids), {},
                          lambda: bucket_logits_cuda(q, slabs, slab_ids),
                          bucket_logits_cuda),
    }


def _same_bits(a, b):
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return len(a) == len(b) and all(
        torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                    y.view(torch.int32) if y.dtype == torch.float32 else y)
        for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["lss_topk", "simhash_codes",
                                  "bucket_logits"])
def test_custom_op_gives_the_launch_functions_bits(cuda, name):
    """``torch.ops.repro_torch.<name>`` (the op a dry-run's fake tensors
    trace; real tensors reach its CUDA kernel when called directly)
    launches the same kernel once, with the same bits as the wrapper's
    launch function, eager and replayed from a CUDA graph."""
    args, kwargs, direct, counter = _custom_op_cases(cuda)[name]
    op = getattr(torch.ops.repro_torch, name)
    want = direct()
    before = counter.launches
    got = op(*args, **kwargs)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert _same_bits(got, want)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        op(*args, **kwargs)                          # warm-up off-graph
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = counter.launches
    with torch.cuda.graph(graph):
        static = op(*args, **kwargs)
    assert counter.launches == before + 1             # the capture only
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert counter.launches == before + 1             # a replay runs no Python
    assert _same_bits(static, want)
