"""``bucket_logits`` and the unfused bucket-major forward
(``sparse_logits_bucketed``): the port's plain versions against JAX
``impl="ref"`` on the same numpy inputs (CPU), and the port's bucketed
path against its own gather path.

Integer outputs (candidate ids) are exact; logits are allclose at
rtol = atol = 1e-5 for logits of order 1.  Where the largest |logit| is
above 1, atol grows with it: the frameworks sum the d products in other
orders, and the rounding grows with the terms (at d = 897 the logits
reach ~100 and differ by up to ~8e-5).  bf16 inputs are rounded once, to
the same bits in both frameworks, and both sides widen them to fp32
before the product, so they too agree at 1e-5, well inside the 2e-2 that
the JAX package allows its kernel.
"""

import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lss as jlss  # noqa: E402
from repro.core import simhash as jsim  # noqa: E402
from repro.kernels import bucket_logits as j_bucket_logits  # noqa: E402
from repro_torch.convert import lss_index_from_numpy  # noqa: E402
from repro_torch.core import lss as tlss  # noqa: E402
from repro_torch.kernels import _build, bucket_logits, registry  # noqa: E402
from repro_torch.kernels.bucket_logits.ops import (  # noqa: E402
    bucket_logits_cuda, bucket_logits_plan)
from repro_torch.kernels.bucket_logits.ref import bucket_logits_ref  # noqa: E402
from repro_torch.kernels.lss_topk.slabs import dequantize_slabs  # noqa: E402
from repro_torch.testing.parity import (assert_close,  # noqa: E402
                                        assert_ints_equal, margin_rows)

ATOL = RTOL = 1e-5
# (B, d, S, P, L): the sweep of the JAX package's tests/test_kernels.py
SWEEP = [(16, 128, 32, 128, 1), (8, 100, 48, 96, 3), (4, 64, 8, 256, 2),
         (32, 897, 16, 24, 1)]
J_DTYPES = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
T_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _assert_logits_close(got, want, what):
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    assert_close(got, want, rtol=RTOL, atol=ATOL * scale, what=what)


def _inputs(seed, bsz, d, n_slabs, cap, n_tables):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bsz, d)).astype(np.float32)
    w = rng.normal(size=(n_slabs, cap, d)).astype(np.float32)
    ids = rng.integers(0, n_slabs, size=(bsz, n_tables)).astype(np.int32)
    return q, w, ids


def _jax_ref(q, w, ids, q_dtype="fp32", w_dtype="fp32"):
    fn = jax.jit(functools.partial(j_bucket_logits, impl="ref"))
    return np.asarray(fn(jnp.asarray(q).astype(J_DTYPES[q_dtype]),
                         jnp.asarray(w).astype(J_DTYPES[w_dtype]),
                         jnp.asarray(ids)))


@pytest.mark.parametrize("bsz,d,n_slabs,cap,n_tables", SWEEP)
def test_ref_matches_jax_sweep(bsz, d, n_slabs, cap, n_tables):
    q, w, ids = _inputs(bsz * cap, bsz, d, n_slabs, cap, n_tables)
    want = _jax_ref(q, w, ids)
    got = bucket_logits(torch.from_numpy(q), torch.from_numpy(w),
                        torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (bsz, n_tables, cap)
    _assert_logits_close(got, want, "bucket_logits")


@pytest.mark.parametrize("q_dtype,w_dtype", [("fp32", "fp32"),
                                             ("bf16", "bf16"),
                                             ("fp32", "bf16")])
def test_ref_matches_jax_dtypes(q_dtype, w_dtype):
    q, w, ids = _inputs(3, 8, 128, 16, 128, 2)
    want = _jax_ref(q, w, ids, q_dtype, w_dtype)
    got = bucket_logits(torch.from_numpy(q).to(T_DTYPES[q_dtype]),
                        torch.from_numpy(w).to(T_DTYPES[w_dtype]),
                        torch.from_numpy(ids))
    assert got.dtype == torch.float32
    _assert_logits_close(got, want, "bucket_logits")


def test_empty_slot_rows_give_zero():
    q, w, ids = _inputs(5, 4, 17, 6, 10, 2)
    w[:, 3] = 0.0                                   # an empty slot per slab
    got = bucket_logits_ref(torch.from_numpy(q), torch.from_numpy(w),
                            torch.from_numpy(ids))
    assert torch.equal(got[:, :, 3], torch.zeros(4, 2))


def test_cpu_tensors_dispatch_to_ref():
    q, w, ids = (torch.from_numpy(a) for a in _inputs(1, 4, 17, 6, 10, 2))
    registry.reset_dispatch_log()
    launches = bucket_logits_cuda.launches
    out = bucket_logits(q, w, ids)
    assert registry.last_dispatch("bucket_logits") == "ref"
    assert bucket_logits_cuda.launches == launches      # no kernel launch
    assert torch.equal(out, bucket_logits_ref(q, w, ids))
    with pytest.raises(RuntimeError, match="no fallback"):
        bucket_logits(q, w, ids, impl="cuda")


def test_cuda_wrapper_refuses_cpu_tensors():
    # the wrapper checks its arguments before it builds or launches
    q, w, ids = (torch.from_numpy(a) for a in _inputs(1, 4, 17, 6, 10, 2))
    launches = bucket_logits_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        bucket_logits_cuda(q, w, ids)
    with pytest.raises(ValueError, match=r"\[B,d\] x \[S,P,d\]"):
        bucket_logits_cuda(q, w[:, :, :5], ids)
    assert bucket_logits_cuda.launches == launches


# ------------------------------------------ sparse_logits_bucketed --

M, D, N = 300, 31, 24
LSS = dict(k_bits=4, n_tables=2)


def _index_np(index):
    return dict(theta=np.array(index.theta),
                table_ids=np.array(index.tables.table_ids),
                n_dropped=np.array(index.tables.n_dropped),
                w_bucketed=np.array(index.w_bucketed),
                w_scale=(None if index.w_scale is None
                         else np.array(index.w_scale)),
                k_bits=index.tables.k_bits, n_tables=index.tables.n_tables,
                capacity=index.tables.capacity)


@pytest.fixture(scope="module")
def jax_bucketed():
    rng = np.random.default_rng(7)
    w = rng.normal(size=(M, D)).astype(np.float32)
    b = rng.normal(size=(M,)).astype(np.float32)
    q = rng.normal(size=(N, D)).astype(np.float32)
    theta = rng.normal(size=(D + 1, 8)).astype(np.float32)
    w_aug = jsim.augment_neurons(jnp.asarray(w), jnp.asarray(b))
    q_aug = jsim.augment_queries(jnp.asarray(q))
    out = {"q_aug": np.array(q_aug), "w_aug": np.array(w_aug),
           "theta": theta}

    @functools.partial(jax.jit, static_argnames=("slab_dtype",))
    def run(q_aug, w_aug, theta, slab_dtype):
        index = jlss.build_index(w_aug, theta, jlss.LSSConfig(
            **LSS, slab_dtype=slab_dtype))
        cand, buckets = jlss.retrieve(q_aug, index, impl="ref")
        logits, ids = jlss.sparse_logits_bucketed(q_aug, index, buckets,
                                                  impl="ref")
        return index, cand, buckets, logits, ids

    for sdt in ("fp32", "bf16", "int8"):
        index, cand, buckets, logits, ids = run(q_aug, w_aug,
                                                jnp.asarray(theta), sdt)
        out[sdt] = dict(index=_index_np(index), cand=np.array(cand),
                        buckets=np.array(buckets), logits=np.array(logits),
                        ids=np.array(ids))
    return out


def test_hash_margin_holds(jax_bucketed):
    assert margin_rows(jax_bucketed["q_aug"], jax_bucketed["theta"]).all()


@pytest.mark.parametrize("slab_dtype", ["fp32", "bf16", "int8"])
def test_sparse_logits_bucketed_matches_jax(jax_bucketed, slab_dtype):
    j = jax_bucketed[slab_dtype]
    index = lss_index_from_numpy(**j["index"], device="cpu")
    q_aug = torch.from_numpy(jax_bucketed["q_aug"])
    cand, buckets = tlss.retrieve(q_aug, index)
    assert_ints_equal(buckets, j["buckets"], what="buckets")
    logits, ids = tlss.sparse_logits_bucketed(q_aug, index, buckets)
    assert ids.shape == (N, LSS["n_tables"] * index.tables.capacity)
    assert_ints_equal(ids, j["ids"], what="ids")
    assert_ints_equal(ids, cand, what="ids vs retrieve")
    # empty slots carry NEG_INF on both sides, so the whole tensor compares
    assert_close(logits, j["logits"], rtol=RTOL, atol=ATOL, what="logits")
    assert bool((logits[ids < 0] == tlss.NEG_INF).all())


def test_bucketed_matches_own_gather_path(jax_bucketed):
    """The port's two unfused paths on the same candidates: ids exact,
    logits allclose where id >= 0 (the contract of the JAX package's
    test_lss.py::test_gather_and_bucketed_logits_agree)."""
    index = lss_index_from_numpy(**jax_bucketed["fp32"]["index"],
                                 device="cpu")
    q_aug = torch.from_numpy(jax_bucketed["q_aug"])
    w_aug = torch.from_numpy(jax_bucketed["w_aug"])
    cand, buckets = tlss.retrieve(q_aug, index)
    lg = tlss.sparse_logits_gather(q_aug, w_aug, cand)
    lb, ids = tlss.sparse_logits_bucketed(q_aug, index, buckets)
    assert torch.equal(ids, cand)
    mask = cand >= 0
    assert bool(mask.any()) and not bool(mask.all())
    assert_close(lb[mask], lg[mask], rtol=RTOL, atol=ATOL,
                 what="bucketed vs gather")


@pytest.mark.parametrize("slab_dtype", ["fp32", "bf16", "int8"])
def test_bucket_slab_inputs_layout(jax_bucketed, slab_dtype):
    """The operands sparse_logits_bucketed hands bucket_logits: fp32 and
    bf16 slabs as stored (a view, no copy), int8 widened by its scales;
    slab ids ``bucket + l * 2^K``."""
    j = jax_bucketed[slab_dtype]
    index = lss_index_from_numpy(**j["index"], device="cpu")
    t = index.tables
    buckets = torch.from_numpy(j["buckets"])
    w_flat, slab_ids = tlss.bucket_slab_inputs(index, buckets)
    assert w_flat.shape == (t.n_tables * t.n_buckets, t.capacity, D + 1)
    if slab_dtype == "int8":
        assert w_flat.dtype == torch.float32
        assert torch.equal(w_flat.reshape(index.w_bucketed.shape),
                           dequantize_slabs(index.w_bucketed, index.w_scale))
    else:
        assert w_flat.dtype == index.w_bucketed.dtype
        assert w_flat.data_ptr() == index.w_bucketed.data_ptr()
    assert slab_ids.dtype == torch.int32
    for l in range(t.n_tables):
        assert torch.equal(slab_ids[:, l], buckets[:, l] + l * t.n_buckets)


# ---------------------------------------------- the kernel's launch plan --
# bucket_logits_plan is what the CUDA wrapper passes to the kernel; these
# run its arithmetic here, as the kernel (csrc/bucket_logits.cu) reads it.

DELICIOUS_SHAPES = [(1, 1, 808), (256, 1, 808), (256, 4, 1608)]   # B, L, P
PLAN_SHAPES = [(b, l, p, 129, dt) for b, l, p in DELICIOUS_SHAPES
               for dt in (torch.float32, torch.bfloat16)]
PLAN_SHAPES += [(7, 3, 33, 17, torch.float32), (5, 2, 45, 33, torch.bfloat16),
                (3, 1, 1, 129, torch.float32), (2, 2, 10, 0, torch.float32),
                (9, 1, 4000, 897, torch.float32)]


def _tiles(slab_ids, group):
    """The kernel's grouping: the (b, l)s on one slab, in (b, l) order, cut
    into tiles of ``group``; a tile is served by its first (b, l)'s blocks.
    Returns {leader: members}."""
    flat = list(np.asarray(slab_ids).reshape(-1))
    tiles = {}
    for bl, s in enumerate(flat):
        rank = flat[:bl].count(s)
        if rank % group == 0:
            tiles[bl] = [e for e in range(bl, len(flat))
                         if flat[e] == s][:group]
    return tiles


def _rows_written(plan, n_bl, cap, tiles):
    """Each (b, l, row) the launch writes, with repeats: block x serves rows
    [r_begin, r_end) of (b, l) = x // splits; warp w takes chunks w,
    w + warps, ... of `rows` rows; a leader writes them for its tile."""
    written = []
    for x in range(plan.blocks):
        bl, split = divmod(x, plan.splits)
        if bl not in tiles:
            continue
        r_begin = split * plan.block_rows
        r_end = min(cap, r_begin + plan.block_rows)
        n_chunks = -(-(r_end - r_begin) // plan.rows)
        for warp in range(plan.warps):
            for n in range(warp, n_chunks, plan.warps):
                r0 = r_begin + n * plan.rows
                for member in tiles[bl]:
                    written += [(member, r) for r in
                                range(r0, min(r0 + plan.rows, r_end))]
    return written


@pytest.mark.parametrize("bsz,n_tables,cap,d,dtype", PLAN_SHAPES)
def test_plan_writes_every_row_once(bsz, n_tables, cap, d, dtype):
    """Without grouping (distinct slabs) and with it (few slabs, so tiles
    of several queries), every (b, l, row) is written exactly once."""
    plan = bucket_logits_plan(bsz, n_tables, cap, d, dtype)
    n_bl = bsz * n_tables
    assert plan.blocks == n_bl * plan.splits
    assert (plan.splits - 1) * plan.block_rows < cap <= \
        plan.splits * plan.block_rows
    rng = np.random.default_rng(bsz + cap)
    for slab_ids in (np.arange(n_bl), rng.integers(0, 3, size=n_bl)):
        tiles = (_tiles(slab_ids, plan.group) if plan.n_ids
                 else {bl: [bl] for bl in range(n_bl)})
        if plan.n_ids:
            assert plan.n_ids == n_bl and plan.group == 4
        written = _rows_written(plan, n_bl, cap, tiles)
        assert len(written) == len(set(written)) == n_bl * cap


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,n_tables,cap", DELICIOUS_SHAPES)
def test_plan_fills_the_card(bsz, n_tables, cap, dtype):
    """At Delicious-200K's width the grid is at least one block per SM at
    B = 1 as at B = 256, and 3 blocks fit on an SM (228 KB, 1 KB of it
    reserved per block)."""
    plan = bucket_logits_plan(bsz, n_tables, cap, 129, dtype)
    assert plan.blocks >= _build.H100_SMS
    assert plan.warps == 8 and plan.smem <= _build.SMEM_LIMIT_BYTES
    assert 3 * (plan.smem + 1024) <= 228 * 1024
    # a warp's chunk is at most ~4 KB of whole rows, 8 rows at a time
    assert plan.rows * 129 * dtype.itemsize <= 4224
    assert plan.stage == ((plan.rows * 129 * dtype.itemsize + 15) & ~15) + 32
    if bsz == 1:      # one slab over the SMs: no slab ids read, no grouping
        assert (plan.n_ids, plan.group) == (0, 1)
        assert plan.block_rows * plan.splits >= cap and plan.splits >= 132
    else:             # the ids a block reads are <= 1/32 of its rows' bytes
        assert plan.block_rows * 129 * dtype.itemsize >= 32 * 4 * plan.n_ids


def test_plan_for_wide_rows():
    """Rows too wide for 8 rings give up grouping, then warps; rows too
    wide for one ring leave no warp, which the wrapper refuses."""
    for d in (129, 2049, 7000, 19000):
        plan = bucket_logits_plan(2, 1, 5, d)
        assert plan.smem <= _build.SMEM_LIMIT_BYTES
        assert plan.warps == (8 if d <= 2049 else (3 if d == 7000 else 1))
        assert (plan.n_ids, plan.group) == ((2, 4) if d <= 2049 else (0, 1))
    assert bucket_logits_plan(2, 1, 5, 30000).warps == 0


def _bulk_copy_span(addr, nbytes):
    """The kernel's copy of ``[addr, addr + nbytes)``: ``(start, size)``
    rounded out to 16 B at both ends (``bulk_span``, csrc/bulk_copy.cuh)."""
    start = addr & ~15
    return start, ((addr + nbytes + 15) & ~15) - start


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [129, 17, 33])
def test_bulk_copy_spans_fit_their_stage(dtype, d):
    """Every chunk of every block, rounded out to 16 B, is 16-byte aligned,
    covers its rows, fits in a ring stage, and leaves the rows at an
    offset that is a multiple of the element size, for slab tensors whose
    data_ptr is aligned or 2 bytes past it."""
    itemsize = dtype.itemsize
    for bsz, n_tables, cap in ((1, 1, 808), (256, 1, 808), (5, 2, 45)):
        plan = bucket_logits_plan(bsz, n_tables, cap, d, dtype)
        row_bytes = d * itemsize
        chunks = set()
        for split in range(plan.splits):
            r_begin = split * plan.block_rows
            r_end = min(cap, r_begin + plan.block_rows)
            for r0 in range(r_begin, r_end, plan.rows):
                chunks.add((r0, min(plan.rows, r_end - r0)))
        for base in (0, 256, 256 + itemsize):        # the tensor's data_ptr
            for s in range(4):                       # the slab
                for r0, n in chunks:
                    addr = base + (s * cap + r0) * row_bytes
                    lo, size = _bulk_copy_span(addr, n * row_bytes)
                    assert lo % 16 == 0 and size % 16 == 0
                    assert lo <= addr and addr + n * row_bytes <= lo + size
                    assert size <= plan.stage and (addr - lo) % itemsize == 0


def test_build_headers_list_every_include():
    """_build.HEADERS goes into every library's digest, so a header missing
    from it would let an edit load a stale library."""
    includes = set()
    for f in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
        includes |= set(re.findall(r'#include\s+"([^"]+)"', f.read_text()))
    assert includes and includes <= set(_build.HEADERS)
    assert set(_build.HEADERS) == {f.name for f in _build.CSRC.glob("*.cuh")}
    assert {f.stem for f in _build.CSRC.glob("*.cu")} == set(_build.KERNELS)
