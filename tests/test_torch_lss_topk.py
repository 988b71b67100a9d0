"""``lss_topk``: the port's plain version against JAX
``lss_topk(impl="ref")`` on the same numpy inputs (CPU).

Integer outputs (candidates, sample sizes, top ids) are exact; top
logits are allclose with atol 1e-5 (the JAX package's own impls differ by
about 2e-6: the products sum in another order).  The inputs hold the hash
margin on every query, and carry empty slots, an all-(-1) bucket and
duplicate ids within and across tables.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.lss_topk import lss_topk as j_lss_topk  # noqa: E402
from repro.kernels.lss_topk import dedup as j_dedup  # noqa: E402
from repro.optim.compression import quantize_int8_rows as j_quant  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.lss_topk import dedup as t_dedup  # noqa: E402
from repro_torch.kernels.lss_topk import lss_topk  # noqa: E402
from repro_torch.kernels._build import SMEM_LIMIT_BYTES  # noqa: E402
from repro_torch.kernels.lss_topk.ops import (  # noqa: E402
    lss_topk_cuda, lss_topk_layout, lss_topk_scratch_bytes,
    lss_topk_smem_bytes)
from repro_torch.kernels.lss_topk.slabs import (  # noqa: E402
    lss_topk_slab_dma_bytes, quantize_slabs)
from repro_torch.optim.compression import (  # noqa: E402
    dequantize_int8_rows, quantize_int8_rows)
from repro_torch.testing.parity import (assert_close,  # noqa: E402
                                        assert_ints_equal,
                                        assert_topk_ids_equal, margin_rows)

ATOL = RTOL = 1e-5
SMALL = dict(bsz=8, d=17, k_bits=3, n_tables=2, cap=32, m=50)    # C = 64
LARGE = dict(bsz=4, d=17, k_bits=2, n_tables=3, cap=88, m=150)   # C = 264


def _case(seed, bsz, d, k_bits, n_tables, cap, m):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bsz, d)).astype(np.float32)
    q[:, -1] = 0.0                                  # [q, 0] augmentation
    theta = rng.normal(size=(d, k_bits * n_tables)).astype(np.float32)
    assert margin_rows(q, theta).all()
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    bits = (qn @ theta > 0).reshape(bsz, n_tables, k_bits)
    buckets = (bits * (1 << np.arange(k_bits))).sum(-1)          # [B, L]
    nb = 2 ** k_bits
    # ids drawn from a small vocabulary: duplicates within and across
    # tables; a quarter of the slots empty
    tids = rng.integers(0, m, size=(n_tables, nb, cap)).astype(np.int32)
    tids[rng.random(tids.shape) < 0.25] = -1
    # query 0 hits only empty slots in every table
    for t in range(n_tables):
        tids[t, buckets[0, t]] = -1
    # query 1: table 1's slab holds table 0's ids slot-reversed
    b0, b1 = buckets[1, 0], buckets[1, 1]
    if b0 != buckets[0, 0] and b1 != buckets[0, 1]:
        tids[1, b1] = tids[0, b0][::-1]
    wb = rng.normal(size=(n_tables, nb, cap, d)).astype(np.float32)
    wb[tids < 0] = 0.0
    return q, theta, tids, wb


@pytest.fixture(scope="module")
def small():
    return _case(0, **SMALL)


@pytest.fixture(scope="module")
def large():
    return _case(1, **LARGE)


def _slabs(wb, slab_dtype):
    """The same stored slabs for both packages (int8 quantized by each)."""
    if slab_dtype == "fp32":
        return jnp.asarray(wb), None, torch.from_numpy(wb), None
    if slab_dtype == "bf16":
        return (jnp.asarray(wb).astype(jnp.bfloat16), None,
                torch.from_numpy(wb).to(torch.bfloat16), None)
    jq, js = j_quant(jnp.asarray(wb))
    tq, ts = quantize_int8_rows(torch.from_numpy(wb))
    return jq, js, tq, ts


def _compare(case, slab_dtype, top_k, dedup=None):
    q, theta, tids, wb = case
    jw, js, tw, ts = _slabs(wb, slab_dtype)
    # jitted: one compile of the whole ref graph instead of one per eager op
    ref = jax.jit(functools.partial(j_lss_topk, top_k=top_k, impl="ref",
                                    dedup=dedup))
    want = ref(jnp.asarray(q), jnp.asarray(theta), jnp.asarray(tids), jw,
               w_scale=js)
    want = [np.asarray(a) for a in want]
    got = lss_topk(torch.from_numpy(q), torch.from_numpy(theta),
                   torch.from_numpy(tids), tw, top_k=top_k, dedup=dedup,
                   w_scale=ts)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert [g.dtype for g in got] == [torch.float32] + [torch.int32] * 3
    assert_ints_equal(got[3], want[3], what="cand")
    assert_ints_equal(got[2], want[2], what="sample")
    assert_close(got[0], want[0], rtol=RTOL, atol=ATOL, what="top_logits")
    assert_topk_ids_equal(got[1], want[1], want[0], ATOL, what="top_ids")
    return got


@pytest.mark.parametrize("slab_dtype", ["fp32", "bf16", "int8"])
def test_quadratic_matches_jax(small, slab_dtype):
    registry.reset_dispatch_log()
    got = _compare(small, slab_dtype, top_k=5)
    assert registry.last_dispatch("lss_topk.dedup") == "quadratic"
    assert registry.last_dispatch("lss_topk") == "ref"
    # query 0 hit only empty slots: nothing sampled, every id -1
    assert int(got[2][0]) == 0
    assert (got[1][0] == -1).all() and (got[0][0] == -1e30).all()


def test_bitonic_equals_quadratic_at_small_c(small):
    q, theta, tids, wb = (torch.from_numpy(a) for a in small)
    quad = lss_topk(q, theta, tids, wb, top_k=5, dedup="quadratic")
    bito = lss_topk(q, theta, tids, wb, top_k=5, dedup="bitonic")
    for a, b in zip(quad, bito):
        assert torch.equal(a, b)


def test_auto_bitonic_non_pow2_c_matches_jax(large):
    registry.reset_dispatch_log()
    _compare(large, "fp32", top_k=5)
    assert registry.last_dispatch("lss_topk.dedup") == "bitonic"


def test_top_k_equals_c(small):
    c = SMALL["n_tables"] * SMALL["cap"]
    got = _compare(small, "fp32", top_k=c)
    n_valid = (got[1] >= 0).sum(-1)
    assert torch.equal(n_valid.to(torch.int32), got[2])   # ids == sample


def test_cpu_tensors_never_launch(small):
    q, theta, tids, wb = small
    before = lss_topk_cuda.launches
    lss_topk(torch.from_numpy(q), torch.from_numpy(theta),
             torch.from_numpy(tids), torch.from_numpy(wb), top_k=3)
    assert lss_topk_cuda.launches == before
    with pytest.raises(RuntimeError, match="no fallback"):
        lss_topk(torch.from_numpy(q), torch.from_numpy(theta),
                 torch.from_numpy(tids), torch.from_numpy(wb), top_k=3,
                 impl="cuda")


def test_int8_without_scales_raises(small):
    q, theta, tids, wb = small
    tq, _ = quantize_int8_rows(torch.from_numpy(wb))
    with pytest.raises(ValueError, match="w_scale"):
        lss_topk(torch.from_numpy(q), torch.from_numpy(theta),
                 torch.from_numpy(tids), tq, top_k=3)


@pytest.mark.parametrize("c", [1, 7, 64, 100, 264])
def test_dedup_masks_agree(c):
    rng = np.random.default_rng(c)
    ids = rng.integers(-1, max(c // 3, 2), size=(6, c)).astype(np.int32)
    t_ids = torch.from_numpy(ids)
    quad = t_dedup.dedup_mask_quadratic(t_ids)
    assert torch.equal(quad, t_dedup.dedup_mask_bitonic(t_ids))
    np.testing.assert_array_equal(
        quad.numpy(), np.asarray(j_dedup.dedup_mask_quadratic(
            jnp.asarray(ids))))


def test_quantize_int8_rows_exact():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 4, 129)).astype(np.float32)
    x[0, 0] = 0.0                                    # an empty slot row
    x[1, 2, 3] = 127 * 0.5                           # a half-way rounding
    jq, js = j_quant(jnp.asarray(x))
    tq, ts = quantize_int8_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = dequantize_int8_rows(tq, ts)
    assert torch.equal(back[0, 0], torch.zeros(129))
    wq, ws = quantize_slabs(torch.from_numpy(x), "int8")
    assert torch.equal(wq, tq) and torch.equal(ws, ts)


def test_bf16_cast_matches_jax():
    x = np.random.default_rng(6).normal(size=(64, 33)).astype(np.float32)
    tb = quantize_slabs(torch.from_numpy(x), "bf16")[0].float().numpy()
    jb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(tb, jb)


def test_shared_memory_and_slab_bytes_at_delicious():
    # P=808, d=129, K=9, L=1, fp32: for each of the 8 warps 2 mbarriers
    # and a ring of 2 stages of 8 rows (8 * 516 B + 32 B of round-out) |
    # q, q/|q|, theta [129, 9], reduce scratch, slab, span, bits, count |
    # C ids and logits + a 2,048-entry hash table of slot positions
    lay = lss_topk_layout(129, 9, 1, 808)
    assert (lay.rows, lay.stage, lay.hash) == (8, 4160, 2048)
    assert lay.smem == 8 * 2 * (8 + 4160) + 5856 + (4 * 808 * 2 + 4 * 2048)
    assert lay.scratch == 0 and 2 * (lay.smem + 1024) <= 228 * 1024
    assert lss_topk_smem_bytes(129, 9, 1, 808) == lay.smem
    # K=8, L=4, P=1608 (C=6432) keeps its per-slot arrays in the block
    assert 48 * 1024 < lss_topk_smem_bytes(129, 8, 4, 1608) <= SMEM_LIMIT_BYTES
    assert lss_topk_scratch_bytes(129, 8, 4, 1608) == 0
    # C=16384 (K=8, L=4, P=4096, and the JAX test's d=16, L=2, P=8192) is
    # served: its ids, logits and 32,768-entry hash table go to 256 KiB of
    # scratch per query, and the block keeps q, theta and the ring
    for shape in ((129, 8, 4, 4096), (16, 2, 2, 8192)):
        big = lss_topk_layout(*shape)
        assert big.smem <= SMEM_LIMIT_BYTES and big.hash == 32768
        assert big.scratch == 4 * 16384 * 2 + 4 * 32768 == 262_144
    assert lss_topk_scratch_bytes(129, 8, 4, 4096, "int8") == 327_680
    # theta and the ring above the limit: the wide layout keeps one copy
    # of q in the block and reads theta and the rows from global memory
    wide = lss_topk_layout(129, 32, 16, 64)
    assert wide.wide and (wide.rows, wide.stage) == (8, 0)
    assert lss_topk_smem_bytes(129, 32, 16, 64) <= SMEM_LIMIT_BYTES
    assert lss_topk_slab_dma_bytes(1, 808, 129) == 420_160


def _bulk_copy_span(addr, nbytes):
    """The kernel's copy of ``[addr, addr + nbytes)``: ``(start, size)``
    rounded out to 16 B at both ends, as a 1D ``cp.async.bulk`` needs
    (``lo``/``hi`` in ``fetch``, ``csrc/lss_topk.cu``)."""
    start = addr & ~15
    return start, ((addr + nbytes + 15) & ~15) - start


@pytest.mark.parametrize("slab_dtype", ["fp32", "bf16", "int8"])
def test_bulk_copy_spans_fit_their_stage(slab_dtype):
    """Every chunk the kernel copies, rounded out to 16 B, is 16-byte
    aligned, covers its rows, fits in a ring stage, and leaves the rows at
    an offset that is a multiple of the element size."""
    itemsize = {"fp32": 4, "bf16": 2, "int8": 1}[slab_dtype]
    for d, cap in ((129, 808), (17, 33), (33, 88), (16, 8192)):
        lay = lss_topk_layout(d, 2, 2, cap, slab_dtype)
        row_bytes = d * itemsize
        assert lay.rows * row_bytes <= max(4224, row_bytes)
        starts = {(s * cap + r0) * row_bytes
                  for s in range(16) for r0 in range(0, cap, lay.rows)}
        for base in (0, 256, 256 + itemsize):   # the tensor's data_ptr
            for start in starts:
                for rows in {1, lay.rows, max(1, lay.rows - 3)}:
                    addr, n = base + start, rows * row_bytes
                    lo, size = _bulk_copy_span(addr, n)
                    assert lo % 16 == 0 and size % 16 == 0
                    assert lo <= addr and addr + n <= lo + size
                    assert lo + 16 > addr and size < n + 32
                    assert size <= lay.stage and (addr - lo) % itemsize == 0
    # an int8 slab of Delicious starts 16-byte aligned only for even s
    assert [(s * 808 * 129) % 16 for s in range(4)] == [0, 8, 0, 8]


def _dedup_case(seed, bsz=4, d=16, k_bits=2, n_tables=2, cap=8192):
    """tests/test_dedup.py's large-C input, from numpy: ids drawn from
    [-1, C/2), every slot row random."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bsz, d)).astype(np.float32)
    theta = rng.normal(size=(d, k_bits * n_tables)).astype(np.float32)
    assert margin_rows(q, theta).all()
    tids = rng.integers(-1, n_tables * cap // 2,
                        size=(n_tables, 2 ** k_bits, cap)).astype(np.int32)
    wb = rng.normal(size=(n_tables, 2 ** k_bits, cap, d)).astype(np.float32)
    return q, theta, tids, wb


def test_c16384_matches_jax():
    registry.reset_dispatch_log()
    got = _compare(_dedup_case(3), "fp32", top_k=5)
    assert registry.last_dispatch("lss_topk.dedup") == "bitonic"
    assert (got[2] > 6000).all() and (got[1] >= 0).all()
