"""The port's paged KV cache + prefix caching on the CPU (counterpart of
``tests/test_paged_decode.py``): bit-exactness of the paged layout
against the dense slabs (blocking, interleaved join/leave, prefix-shared
and partially-shared sessions, page-boundary crossings), KVCachePool
slot/page accounting (double free raises, exhaustion unwinds, refcounts
under prefix sharing — including a seeded property sweep, LRU eviction),
the scheduler shedding only a starved session, and one prefill build per
power-of-two bucket."""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch.core.lss import LSSConfig  # noqa: E402
from repro_torch.data.synthetic import lm_dataset  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import (KVCachePool, KVPoolExhaustedError,  # noqa: E402
                               LMDecoder)
from repro_torch.serve.decode.scheduler import (  # noqa: E402
    _PREFILL_COMPILES, _prefill_bucket)

VOCAB = 512
PROMPT_LEN = 6
MAX_LEN = 24
PAGE = 8                 # pages_per_slot = 3 at MAX_LEN=24
T_OUT = 120.0

CFG = T.TransformerConfig(name="tp", n_layers=2, d_model=32, n_heads=2,
                          n_kv_heads=2, head_dim=16, d_ff=64, vocab=VOCAB,
                          dtype=torch.float32, kv_chunk=32)


@pytest.fixture(scope="module")
def lm():
    params = T.init_params(torch.Generator().manual_seed(0), CFG,
                           device="cpu")
    return params, lm_dataset(0, 64 * 33, VOCAB, 33)


def _decoder(params, layout, *, page_tokens=PAGE, max_streams=3,
             max_len=MAX_LEN):
    dec = LMDecoder(params, CFG, LSSConfig(k_bits=4, n_tables=2),
                    max_streams=max_streams, max_len=max_len,
                    kv_layout=layout, kv_page_tokens=page_tokens)
    # the same seed in both layouts: the same index
    dec.engine.fit_random(torch.Generator().manual_seed(1))
    return dec


@pytest.fixture(scope="module")
def dense_dec(lm):
    return _decoder(lm[0], "dense")


@pytest.fixture(scope="module")
def paged_dec(lm):
    return _decoder(lm[0], "paged")


@pytest.fixture(scope="module")
def dense4_dec(lm):
    return _decoder(lm[0], "dense", page_tokens=4)


@pytest.fixture(scope="module")
def paged4_dec(lm):
    return _decoder(lm[0], "paged", page_tokens=4)


def _gen(dec, prompt, steps, head="full"):
    return dec.generate(np.asarray(prompt)[None], steps=steps, head=head,
                        timeout=T_OUT).numpy()[0]


# ------------------------------------------------- paged == dense exact --

@pytest.mark.parametrize("head", ["full", "lss"])
def test_paged_blocking_exact_vs_dense(dense_dec, paged_dec, lm, head):
    toks = lm[1]
    for i in range(3):
        a = _gen(dense_dec, toks[i, :PROMPT_LEN], 8, head)
        b = _gen(paged_dec, toks[i, :PROMPT_LEN], 8, head)
        np.testing.assert_array_equal(a, b, err_msg=f"row {i} head {head}")
    # the paged step is its own step under a distinct tag
    assert (head, f"decode[3x{MAX_LEN},paged{PAGE}]@tp") \
        in paged_dec.engine.compile_counts


@pytest.mark.parametrize("head", ["full", "lss"])
def test_paged_interleaved_join_leave_exact(dense_dec, paged_dec, lm, head):
    """5 sessions through 3 paged slots with staggered budgets (page
    recycling in anger) match one-at-a-time dense blocking generate."""
    toks = lm[1]
    budgets = [3, 6, 9, 4, 12]
    seq = [_gen(dense_dec, toks[i, :PROMPT_LEN], budgets[i], head)
           for i in range(5)]
    sched = paged_dec.scheduler(head=head)
    streams = [sched.submit(toks[i, :PROMPT_LEN], max_new_tokens=budgets[i])
               for i in range(5)]
    sched.run(timeout=T_OUT)
    for i, st_ in enumerate(streams):
        assert st_.finish_reason == "max_tokens"
        np.testing.assert_array_equal(st_.result(timeout=1.0), seq[i],
                                      err_msg=f"session {i} head {head}")
    assert sched.pool.n_free == sched.max_streams


def test_prefix_shared_sessions_skip_prefill_and_stay_exact(
        dense_dec, paged_dec, lm):
    """Identical prompts: the first join prefills and registers its
    pages; every later join maps straight from the cache (no prefill, no
    head rank) and still produces bit-identical tokens."""
    prompt = lm[1][9, :PROMPT_LEN]
    ref = _gen(dense_dec, prompt, 7)
    sched = paged_dec.scheduler(head="full")
    sched.reset_stats()
    streams = [sched.submit(prompt, max_new_tokens=7) for _ in range(5)]
    sched.run(timeout=T_OUT)
    for st_ in streams:
        np.testing.assert_array_equal(st_.result(timeout=1.0), ref)
    s = sched.stats()
    assert s.n_prefill_skipped >= 4          # all but (at most) the first
    assert s.prefix_hit_rate > 0


def test_partial_prefix_share_and_divergence_exact(dense4_dec, paged4_dec,
                                                   lm):
    """Two prompts sharing full pages but diverging in the remainder: the
    shared full pages come from the cache, the divergent remainder does
    not, and both sessions decode exactly."""
    a = lm[1][3, :10].copy()
    b = a.copy()
    b[-1] = (b[-1] + 1) % VOCAB              # diverge inside the rem page
    refs = [_gen(dense4_dec, p, 5) for p in (a, b)]
    sched = paged4_dec.scheduler(head="full")
    st_a = sched.submit(a, max_new_tokens=5)
    sched.run(timeout=T_OUT, until=st_a.done)
    hits0 = sched.pool.prefix_hits
    st_b = sched.submit(b, max_new_tokens=5)
    sched.run(timeout=T_OUT)
    np.testing.assert_array_equal(st_a.result(timeout=1.0), refs[0])
    np.testing.assert_array_equal(st_b.result(timeout=1.0), refs[1])
    # b reused a's two full pages (tokens 0..7) but NOT the remainder
    assert sched.pool.prefix_hits - hits0 == 2


def test_page_boundary_crossing_exact(dense4_dec, paged4_dec, lm):
    """A tiny page size forces several advance-time page allocations per
    session; tokens still match dense exactly."""
    for i in (11, 12):
        a = _gen(dense4_dec, lm[1][i, :5], 14)
        b = _gen(paged4_dec, lm[1][i, :5], 14)
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ pool accounting --

def _pool(**kw):
    return KVCachePool(CFG, device="cpu", **kw)


def _dummy_kv(s):
    shape = (CFG.n_layers, 1, s, CFG.n_kv_heads, CFG.head_dim)
    return torch.zeros(shape), torch.zeros(shape)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_pool_slot_validation(layout):
    pool = _pool(max_streams=2, max_len=16, layout=layout, page_tokens=PAGE)
    a, b = pool.alloc(), pool.alloc()
    assert {a, b} == {0, 1} and pool.alloc() is None   # exhaustion: None
    pool.free(a)
    with pytest.raises(ValueError):                    # double free
        pool.free(a)
    with pytest.raises(ValueError):                    # out of range
        pool.free(7)
    k, v = _dummy_kv(8)
    with pytest.raises(ValueError):                    # join unowned slot
        pool.join(a, k, v, 4)
    with pytest.raises(ValueError):                    # length > width
        pool.join(b, k, v, 17)
    assert pool.alloc() == a                           # free -> reuse
    pool.join(a, k, v, 4)
    assert pool.lengths[a] == 4


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_join_writes_the_prefill_where_the_step_reads_it(layout):
    """A join's KV lands at the slot's positions 0..S-1: in the dense slab
    row, or in the pages its table row maps, in order."""
    pool = _pool(max_streams=2, max_len=16, layout=layout, page_tokens=4)
    k = torch.arange(CFG.n_layers * 10 * CFG.n_kv_heads * CFG.head_dim,
                     dtype=torch.float32).reshape(CFG.n_layers, 1, 10,
                                                  CFG.n_kv_heads,
                                                  CFG.head_dim)
    pool.alloc()
    s = pool.alloc()
    pool.join(s, k, -k, 10, prompt=np.arange(10, dtype=np.int32), bucket=16)
    if layout == "dense":
        got_k, got_v = pool.k[:, s, :10], pool.v[:, s, :10]
    else:
        row = torch.from_numpy(pool.page_table[s][:3].astype(np.int64))
        got_k = pool.k[:, row].reshape(CFG.n_layers, 12, CFG.n_kv_heads,
                                       CFG.head_dim)[:, :10]
        got_v = pool.v[:, row].reshape(CFG.n_layers, 12, CFG.n_kv_heads,
                                       CFG.head_dim)[:, :10]
        assert bool((pool.k[:, 0] == 0).all())        # scratch untouched
    assert torch.equal(got_k, k[:, 0]) and torch.equal(got_v, -k[:, 0])


def test_page_refcounting_under_prefix_sharing():
    pool = _pool(max_streams=3, max_len=16, layout="paged", page_tokens=4)
    prompt = np.arange(10, dtype=np.int32)
    k, v = _dummy_kv(12)
    s0 = pool.alloc()
    pool.join(s0, k, v, 10, prompt=prompt, bucket=16)
    row0 = pool.page_table[s0].copy()
    assert (row0[:3] > 0).all() and row0[3] == 0       # 2 full + 1 rem
    assert all(pool._ref[p] == 2 for p in row0[:3])   # slot AND cache
    s1 = pool.alloc()
    pool.join(s1, k, v, 10, prompt=prompt, bucket=16)
    row1 = pool.page_table[s1]
    np.testing.assert_array_equal(row0[:2], row1[:2])  # full pages shared
    assert row1[2] != row0[2]                          # rem NOT shared
    assert all(pool._ref[p] == 3 for p in row0[:2])
    assert pool._ref[row0[2]] == 2 and pool._ref[row1[2]] == 1
    pool.free(s0)
    assert all(pool._ref[p] == 2 for p in row0[:2])    # s1 + cache
    assert pool._ref[row0[2]] == 1                     # cache only
    pool.free(s1)
    assert all(pool._ref[p] == 1 for p in row0[:3])
    assert pool.pages_in_use == 3
    # full-prompt cache join: maps both full pages + a CoW'd remainder
    s2 = pool.alloc()
    pool.k[:, row0[2]] = 7.0                           # the cached rem page
    assert pool.join_from_cache(s2, prompt, 10, bucket=16)
    row2 = pool.page_table[s2]
    np.testing.assert_array_equal(row2[:2], row0[:2])
    assert row2[2] not in (0, row0[2])                 # fresh CoW page
    assert bool((pool.k[:, row2[2]] == 7.0).all())     # ... with its bits
    # a different bucket is a different reduction shape: never a hit
    s3 = pool.alloc()
    assert not pool.join_from_cache(s3, prompt, 10, bucket=32)


def test_paged_pool_page_exhaustion_raises():
    pool = _pool(max_streams=2, max_len=16, layout="paged", page_tokens=4,
                 n_pages=3)                            # scratch + 2 pages
    k, v = _dummy_kv(12)
    s0 = pool.alloc()
    pool.join(s0, k, v, 5)                             # needs 2 pages
    s1 = pool.alloc()
    with pytest.raises(KVPoolExhaustedError):
        pool.join(s1, k, v, 5)                         # nothing evictable


def test_join_from_cache_cow_alloc_cannot_evict_own_pages():
    """The COW page allocation inside join_from_cache runs the LRU
    evictor; the pages of the in-progress join are pinned, so eviction
    takes an UNRELATED cache-only page and the join completes."""
    pool = _pool(max_streams=3, max_len=8, layout="paged", page_tokens=4,
                 n_pages=4)                            # scratch + 3 pages
    k, v = _dummy_kv(8)
    pa = np.arange(6, dtype=np.int32)                  # 1 full + 1 rem page
    pb = np.arange(10, 13, dtype=np.int32)             # 1 rem page
    s = pool.alloc()
    pool.join(s, k, v, 6, prompt=pa, bucket=8)
    pool.free(s)                                       # pa pages: cache-only
    s = pool.alloc()
    pool.join(s, k, v, 3, prompt=pb, bucket=8)
    pool.free(s)                                       # pb page: cache-only
    assert pool.n_free_pages == 0                      # all 3 pages cached
    s = pool.alloc()
    assert pool.join_from_cache(s, pa, 6, bucket=8)    # must NOT eat pa
    row = pool.page_table[s]
    assert (row[:2] > 0).all() and pool.lengths[s] == 6
    assert pool._ref[row[0]] == 2                      # full: cache + session
    assert pool._ref[row[1]] == 1                      # fresh CoW write page
    s2 = pool.alloc()
    assert not pool.join_from_cache(s2, pb, 3, bucket=8)


def test_join_from_cache_exhaustion_unwinds_cleanly():
    pool = _pool(max_streams=3, max_len=8, layout="paged", page_tokens=4,
                 n_pages=4)                            # scratch + 3 pages
    k, v = _dummy_kv(8)
    pa = np.arange(6, dtype=np.int32)
    s = pool.alloc()
    pool.join(s, k, v, 6, prompt=pa, bucket=8)
    pool.free(s)                                       # 2 cache-only pages
    s1 = pool.alloc()
    pool.join(s1, k, v, 3)                             # 3rd page: live
    assert pool.n_free_pages == 0
    s2 = pool.alloc()
    ref0 = pool._ref.copy()
    cache0, lru0 = dict(pool._cache), list(pool._lru)
    with pytest.raises(KVPoolExhaustedError):
        pool.join_from_cache(s2, pa, 6, bucket=8)      # nothing evictable
    np.testing.assert_array_equal(pool._ref, ref0)
    assert pool._cache == cache0 and list(pool._lru) == lru0
    assert (pool.page_table[s2] == 0).all() and pool.lengths[s2] == 0
    # join() CAN proceed by evicting pa's rem entry for its write page
    pool.join(s2, k, v, 6, prompt=pa, bucket=8)
    assert pool.lengths[s2] == 6


def test_join_exhaustion_unwinds_cleanly():
    pool = _pool(max_streams=3, max_len=8, layout="paged", page_tokens=4,
                 n_pages=3)                            # scratch + 2 pages
    k, v = _dummy_kv(8)
    s0 = pool.alloc()
    pool.join(s0, k, v, 3)                             # 1 page, live
    s1 = pool.alloc()
    ref0 = pool._ref.copy()
    with pytest.raises(KVPoolExhaustedError):
        pool.join(s1, k, v, 6, prompt=np.arange(6, dtype=np.int32),
                  bucket=8)                            # needs 2, 1 left
    np.testing.assert_array_equal(pool._ref, ref0)
    assert not pool._cache                             # no stale entry
    assert (pool.page_table[s1] == 0).all() and pool.lengths[s1] == 0
    assert pool.n_free_pages == 1


def test_advance_reports_starved_slots_without_raising():
    pool = _pool(max_streams=2, max_len=8, layout="paged", page_tokens=4,
                 n_pages=3)                            # scratch + 2 pages
    k, v = _dummy_kv(8)
    s0, s1 = pool.alloc(), pool.alloc()
    pool.join(s0, k, v, 3)
    pool.join(s1, k, v, 2)
    assert pool.n_free_pages == 0
    assert pool.advance([s0, s1]) == [s0]              # s0 hit the boundary
    assert pool.lengths[s0] == 4 and pool.lengths[s1] == 3
    assert pool.page_table[s0, 1] == 0                 # unmapped -> scratch
    pool.free(s0)
    pool.free(s1)
    assert pool.n_free_pages == 2 and pool.pages_in_use == 0


def test_scheduler_sheds_only_starved_session(lm):
    """A session that cannot grow past a page boundary is shed with
    KVPoolExhaustedError; the OTHER session keeps decoding and its tokens
    stay bit-identical to the dense blocking reference."""
    toks = lm[1]
    cfg = CFG._replace(name="tp-oomshed")
    p2 = T.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")

    def mk(layout, pages):
        return LMDecoder(p2, cfg, max_streams=2, max_len=16,
                         kv_layout=layout, kv_page_tokens=4, kv_pages=pages)

    ref = mk("dense", None).generate(toks[1:2, :5], steps=2, head="full",
                                     timeout=T_OUT).numpy()[0]
    sched = mk("paged", 4).scheduler(head="full")      # scratch + 3 pages
    st_a = sched.submit(toks[0, :3], max_new_tokens=10)   # 1 page, grows
    st_b = sched.submit(toks[1, :5], max_new_tokens=2)    # 2 pages
    sched.run(timeout=T_OUT)
    assert st_a.finish_reason == "error"
    assert isinstance(st_a.exception(timeout=1.0), KVPoolExhaustedError)
    assert len(st_a) >= 1                              # landed tokens kept
    assert st_b.finish_reason == "max_tokens"
    np.testing.assert_array_equal(st_b.result(timeout=1.0), ref)
    s = sched.stats()
    assert s.n_shed_kv_oom == 1 and s.n_finished == 1
    assert sched.pool.n_free == sched.max_streams      # accounting drained


def test_evict_lru_cached_pages_under_pressure():
    pool = _pool(max_streams=1, max_len=8, layout="paged", page_tokens=4,
                 n_pages=4)                            # scratch + 3 pages
    k, v = _dummy_kv(8)
    s0 = pool.alloc()
    pa = np.arange(3, dtype=np.int32)
    pb = np.arange(3, 6, dtype=np.int32)
    pool.join(s0, k, v, 3, prompt=pa, bucket=8)        # 1 rem page, cached
    pool.free(s0)
    s0 = pool.alloc()
    pool.join(s0, k, v, 3, prompt=pb, bucket=8)        # 2nd cached page
    pool.free(s0)
    assert pool.pages_in_use == 2 and pool.n_free_pages == 1
    # a 2-page join must evict the LRU cache-only page (pa's) to fit
    s0 = pool.alloc()
    pool.join(s0, k, v, 8, prompt=np.arange(8, dtype=np.int32), bucket=8)
    assert (pool.page_table[s0] > 0).sum() == 2        # len 8 = 2 full pages
    pool.free(s0)
    s0 = pool.alloc()
    assert not pool.join_from_cache(s0, pa, 3, 8)      # pa was evicted


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**32 - 1))
def test_pool_accounting_property(seed):
    """Seeded op-sequence sweep (alloc/join/cache-join/advance/free over
    two shareable prompts): after every op, page refcounts equal the
    number of slot mappings plus cache holds, the free list is disjoint
    from referenced pages, and together they cover the arena."""
    rng = np.random.default_rng(seed)
    pool = _pool(max_streams=3, max_len=16, layout="paged", page_tokens=4)
    k, v = _dummy_kv(12)
    prompts = [np.arange(9, dtype=np.int32),
               np.arange(100, 109, dtype=np.int32)]
    held: list[int] = []

    def check():
        refs = np.zeros(pool.n_pages, np.int64)
        for s in range(pool.max_streams):
            for pid in pool.page_table[s]:
                if pid > 0:
                    refs[pid] += 1
        for pid in pool._cache.values():
            refs[pid] += 1
        np.testing.assert_array_equal(refs[1:], pool._ref[1:])
        assert pool._ref[0] == 0
        free = set(pool._free_pages)
        assert len(free) == len(pool._free_pages)       # no dup frees
        assert all(pool._ref[p] == 0 for p in free)
        assert len(free) + pool.pages_in_use == pool.n_pages - 1

    for _ in range(40):
        op = rng.integers(0, 4)
        if op == 0:
            s = pool.alloc()
            if s is not None:
                held.append(s)
        elif op == 1 and held:
            s = held.pop(int(rng.integers(0, len(held))))
            pool.free(s)
        elif op == 2 and held:
            s = held[int(rng.integers(0, len(held)))]
            p = prompts[int(rng.integers(0, 2))]
            if not (rng.integers(0, 2)
                    and pool.join_from_cache(s, p, 9, bucket=16)):
                pool.join(s, k, v, 9, prompt=p, bucket=16)
        elif op == 3 and held:
            s = held[int(rng.integers(0, len(held)))]
            if 0 < pool.lengths[s] < pool.max_len:
                pool.advance([s])
        check()


# ------------------------------------------------- prefill bucketing --

def test_prefill_bucket_shape():
    assert _prefill_bucket(1) == 8 and _prefill_bucket(8) == 8
    assert _prefill_bucket(9) == 16 and _prefill_bucket(16) == 16
    assert _prefill_bucket(17) == 32 and _prefill_bucket(4096) == 4096


def test_prefill_builds_per_bucket_not_per_length(lm):
    """Distinct prompt lengths within one power-of-two bucket share ONE
    prefill build; the counter (surfaced through DecodeStats) proves it."""
    toks = lm[1]
    cfg = CFG._replace(name="tp-buckets")
    p2 = T.init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    dec = LMDecoder(p2, cfg, max_streams=2, max_len=MAX_LEN)
    sched = dec.scheduler(head="full")
    for plen in (3, 5, 6, 8, 9, 12, 15):     # buckets: {8, 16} only
        st_ = sched.submit(toks[0, :plen], max_new_tokens=2)
        sched.run(timeout=T_OUT, until=st_.done)
    sched.run(timeout=T_OUT)
    s = sched.stats()
    assert s.n_prefill_buckets == 2, dict(_PREFILL_COMPILES)
    assert s.n_prefill_compiles == 2, dict(_PREFILL_COMPILES)
