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
from repro_torch.kernels import bucket_logits, registry  # noqa: E402
from repro_torch.kernels.bucket_logits.ops import bucket_logits_cuda  # noqa: E402
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
