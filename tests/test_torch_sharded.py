"""The vocab-sharded index in one process, port against the JAX package
(``repro.serve.heads.shard_index``, ``repro.core.sharded``) at
``impl="ref"`` on seeded numpy inputs:

* ``shard_index`` (the padded tail masked, fp32/bf16/int8 slabs) for the
  (m, n_shards) range of ``tests/test_heads_padding.py``: table ids and
  ``n_dropped`` exact, slabs and ``w_scale`` allclose, masked slots -1
  and zero; a ``shard_range`` build equals the same shards of a full
  build; ``convert.lss_index_stack_from_numpy`` carries a JAX stack over;
* each shard's ``local_topk`` plus the merge against JAX's per-shard
  ``lss_forward``, concatenation and ``jax.lax.top_k`` (what
  ``sharded_lss_predict`` computes): ids exact away from ties, logits
  within 1e-5, no padded id;
* the two-stage merge bit for bit the flat one on candidates with ties
  and (NEG_INF, -1) slots, and the flat one bit for bit ``jax.lax.top_k``;
* the one-process sharded head bit for bit the ``lss`` head.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lss as jlss  # noqa: E402
from repro.core import simhash as jsim  # noqa: E402
from repro.serve import heads as jheads  # noqa: E402
from repro_torch.convert import (lss_index_stack_from_numpy,  # noqa: E402
                                 tensor_from_numpy)
from repro_torch.core import simhash as tsim  # noqa: E402
from repro_torch.core.lss import LSSConfig, build_index  # noqa: E402
from repro_torch.core.sharded import (hierarchical_topk_merge,  # noqa: E402
                                      local_part, make_sharded_predict,
                                      topk_merge)
from repro_torch.core.topk import NEG_INF  # noqa: E402
from repro_torch.distributed import ServingMesh  # noqa: E402
from repro_torch.kernels.lss_topk.slabs import dequantize_slabs  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.serve.heads import _mask_index_tail, shard_index  # noqa: E402
from repro_torch.testing.parity import (assert_close,  # noqa: E402
                                        assert_topk_ids_equal)

D, TOP_K, N_QUERIES = 8, 3, 6
# (m, n_shards) across test_heads_padding.py's ranges (m 3-40, 2-4
# shards): padded tails of 1 to 3 rows, an empty-ish tail shard (3 over
# 2, 7 over 4) and one even split
CASES = [(3, 2), (7, 4), (10, 4), (23, 3), (37, 2), (40, 3), (16, 4)]
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(m, n_shards, seed=0):
    rng = np.random.default_rng(m * 7 + n_shards + seed)
    w = rng.standard_normal((m, D)).astype(np.float32)
    theta = rng.standard_normal((D + 1, 3 * 2)).astype(np.float32)
    q = rng.standard_normal((N_QUERIES, D)).astype(np.float32)
    return w, theta, q


def _cfgs(slab_dtype, bucket_major=True):
    kw = dict(k_bits=3, n_tables=2, slab_dtype=slab_dtype,
              use_bucket_major=bucket_major)
    return jlss.LSSConfig(**kw), LSSConfig(**kw)


def _jax_stack(w, theta, jcfg, n_shards):
    w_aug = jsim.augment_neurons(jnp.asarray(w), None)
    stack, w_stack, m_local = jheads.shard_index(
        w_aug, jnp.asarray(theta), jcfg, n_shards)
    return jax.tree.map(np.asarray, stack), w_stack, m_local


def _port_stack(w, theta, cfg, n_shards, **kw):
    w_aug = tsim.augment_neurons(torch.from_numpy(w), None)
    return shard_index(w_aug, torch.from_numpy(theta), cfg, n_shards, **kw)


def _slab_values(wb, ws):
    return dequantize_slabs(wb, ws).float().numpy()


@pytest.mark.parametrize("slab_dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("m,n_shards", CASES)
def test_shard_index_matches_jax(m, n_shards, slab_dtype):
    w, theta, _ = _inputs(m, n_shards)
    jcfg, cfg = _cfgs(slab_dtype)
    jstack, _, jm_local = _jax_stack(w, theta, jcfg, n_shards)
    stack, w_stack, m_local = _port_stack(w, theta, cfg, n_shards)
    assert m_local == jm_local and len(stack) == n_shards
    assert w_stack is None
    for s, idx in enumerate(stack):
        ids = idx.tables.table_ids.numpy()
        np.testing.assert_array_equal(ids, jstack.tables.table_ids[s])
        np.testing.assert_array_equal(idx.tables.n_dropped.numpy(),
                                      jstack.tables.n_dropped[s])
        n_valid = min(max(m - s * m_local, 0), m_local)
        assert ids.max(initial=-1) < max(n_valid, 1)
        wb = idx.w_bucketed
        ws = None if idx.w_scale is None else idx.w_scale.numpy()
        assert (wb.float().numpy()[ids < 0] == 0).all()
        if slab_dtype == "int8":
            if n_valid < m_local:     # the masked tail: every empty slot
                assert (ws[ids < 0] == 0).all()
            np.testing.assert_allclose(ws, jstack.w_scale[s], rtol=1e-6)
        j_wb = jstack.w_bucketed[s]
        j_ws = None if jstack.w_scale is None else jstack.w_scale[s]
        got = _slab_values(wb, idx.w_scale)
        want = _slab_values(tensor_from_numpy(j_wb, "cpu"),
                            None if j_ws is None
                            else tensor_from_numpy(j_ws, "cpu"))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("slab_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("m,n_shards", [(23, 3), (37, 2), (10, 4)])
def test_shard_range_build_equals_the_full_build(m, n_shards, slab_dtype):
    w, theta, _ = _inputs(m, n_shards)
    _, cfg = _cfgs(slab_dtype)
    full, _, m_local = _port_stack(w, theta, cfg, n_shards)
    w_aug = tsim.augment_neurons(torch.from_numpy(w), None)
    for lo in range(n_shards):
        for hi in range(lo + 1, n_shards + 1):
            rows = w_aug[min(lo * m_local, m):min(hi * m_local, m)]
            part, _, ml = shard_index(rows, torch.from_numpy(theta), cfg,
                                      n_shards, shard_range=(lo, hi),
                                      m_total=m)
            assert ml == m_local and len(part) == hi - lo
            for a, b in zip(part, full[lo:hi]):
                for x, y in zip((a.theta, a.tables.table_ids,
                                 a.tables.n_dropped, a.w_bucketed,
                                 a.w_scale),
                                (b.theta, b.tables.table_ids,
                                 b.tables.n_dropped, b.w_bucketed,
                                 b.w_scale)):
                    assert (x is None) == (y is None)
                    assert x is None or torch.equal(x, y)
    with pytest.raises(ValueError, match="m_total"):
        shard_index(w_aug, torch.from_numpy(theta), cfg, n_shards,
                    shard_range=(0, 1))
    with pytest.raises(ValueError, match="needs rows"):
        shard_index(w_aug, torch.from_numpy(theta), cfg, n_shards,
                    shard_range=(0, 1), m_total=m)


def test_mask_index_tail_drops_padded_ids():
    w, theta, _ = _inputs(20, 1)
    cfg = LSSConfig(k_bits=3, n_tables=2, slab_dtype="int8")
    w_aug = tsim.augment_neurons(torch.from_numpy(w), None)
    idx = _mask_index_tail(build_index(w_aug, torch.from_numpy(theta), cfg),
                           13)
    ids = idx.tables.table_ids
    assert ids.max() < 13 and ((ids >= 0) | (ids == -1)).all()
    assert (idx.w_bucketed[ids < 0] == 0).all()
    assert (idx.w_scale[ids < 0] == 0).all()


def _jax_oracle(q, jstack, jw_stack, n_shards, m_local, k):
    """JAX's per-shard lss_forward (ref), global ids, concatenation and
    jax.lax.top_k: the body of sharded_lss_forward without shard_map."""
    fwd = jax.jit(functools.partial(jlss.lss_forward, top_k=k, impl="ref"))
    logits, gids, sample = [], [], 0
    for s in range(n_shards):
        idx = jax.tree.map(lambda x, s=s: jnp.asarray(x[s]), jstack)
        w = None if jw_stack is None else jw_stack[s]
        out = fwd(jnp.asarray(q), idx, w)
        ids = np.asarray(out.top_ids)
        logits.append(np.asarray(out.top_logits))
        gids.append(np.where(ids >= 0, ids + s * m_local, -1))
        sample = sample + np.asarray(out.sample_size)
    all_l = np.concatenate(logits, 1)
    top, pos = jax.lax.top_k(jnp.asarray(all_l), k)
    return (np.asarray(top), np.take_along_axis(np.concatenate(gids, 1),
                                                np.asarray(pos), -1),
            sample, all_l)


@pytest.mark.parametrize("slab_dtype,bucket_major",
                         [("fp32", True), ("bf16", True), ("int8", True),
                          ("fp32", False)])
@pytest.mark.parametrize("m,n_shards", [(23, 3), (37, 2), (40, 4), (7, 4)])
def test_local_topk_and_merge_match_jax(m, n_shards, slab_dtype,
                                        bucket_major):
    w, theta, q = _inputs(m, n_shards, seed=1)
    jcfg, cfg = _cfgs(slab_dtype, bucket_major)
    jstack, jw_stack, m_local = _jax_stack(w, theta, jcfg, n_shards)
    want_l, want_i, want_s, all_l = _jax_oracle(q, jstack, jw_stack,
                                                n_shards, m_local, TOP_K)
    stack, w_stack, _ = _port_stack(w, theta, cfg, n_shards)
    assert (w_stack is None) == bucket_major
    part = local_part(torch.from_numpy(q), stack, w_stack, k=TOP_K,
                      shard0=0, m_local=m_local)
    got_l, got_i = topk_merge(part.logits, part.gids, TOP_K)
    np.testing.assert_array_equal(part.sample.numpy(), want_s)
    assert_close(got_l, want_l, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                 what="merged logits")
    next_l = np.sort(all_l, -1)[:, ::-1][:, TOP_K] \
        if all_l.shape[1] > TOP_K else None
    assert_topk_ids_equal(got_i, want_i, want_l, LOGIT_TOL,
                          next_logit=next_l, what="merged ids")
    got_i = got_i.numpy()
    assert ((got_i >= -1) & (got_i < m)).all()     # no padded id
    # make_sharded_predict over an in-process mesh is the same function
    fwd = make_sharded_predict(ServingMesh.local(n_shards), m_local, TOP_K,
                               with_aux=True)
    lg, ids, sample = fwd(torch.from_numpy(q), stack, w_stack)
    assert torch.equal(lg, got_l) and np.array_equal(ids.numpy(), got_i)
    assert torch.equal(sample, part.sample)


def _candidates(rng, b, n_hosts, per_host, k):
    """[B, S*k] shard blocks as local_part gives them: each block sorted
    descending, a few sub-k tails of (NEG_INF, -1), values from a small
    set so ties are common."""
    n = n_hosts * per_host
    logits = np.zeros((b, n, k), np.float32)
    gids = np.zeros((b, n, k), np.int32)
    for s in range(n):
        vals = rng.integers(0, 4, (b, k)).astype(np.float32) / 2
        vals = -np.sort(-vals, -1)
        n_real = rng.integers(0, k + 1, b)
        ids = s * 100 + rng.integers(0, 100, (b, k))
        for i in range(b):
            vals[i, n_real[i]:] = NEG_INF
            ids[i, n_real[i]:] = -1
        logits[:, s], gids[:, s] = vals, ids
    return logits.reshape(b, -1), gids.reshape(b, -1)


@pytest.mark.parametrize("n_hosts,per_host,k",
                         [(1, 3, 4), (2, 1, 3), (2, 2, 6), (3, 2, 1),
                          (4, 3, 5)])
def test_two_stage_merge_is_the_flat_merge_bit_for_bit(n_hosts, per_host, k):
    rng = np.random.default_rng(n_hosts * 10 + per_host + k)
    logits, gids = _candidates(rng, 64, n_hosts, per_host, k)
    lt, gt = torch.from_numpy(logits), torch.from_numpy(gids)
    flat = topk_merge(lt, gt, k)

    def blocks(x, group):
        """Every rank's candidates held here: stage 1 gives each host's
        block (``[n_hosts, B, c]``), stage 2 the hosts' winners side by
        side (``[B, n_hosts*k]``)."""
        if group == "host":
            return x.reshape(x.shape[0], n_hosts, -1).transpose(0, 1)
        return torch.cat(x.unbind(0), -1)

    mesh = ServingMesh(n_hosts=n_hosts, ranks_per_host=per_host,
                       host_group="host", cross_group="cross")
    two = hierarchical_topk_merge(lt, gt, k, mesh=mesh, gather=blocks)
    if n_hosts == 1:          # the one host's block, no stage 2
        two = tuple(t[0] for t in two)
    assert torch.equal(flat[0], two[0]) and torch.equal(flat[1], two[1])
    top, pos = jax.lax.top_k(jnp.asarray(logits), k)    # ties: lowest pos
    np.testing.assert_array_equal(flat[0].numpy(), np.asarray(top))
    np.testing.assert_array_equal(
        flat[1].numpy(), np.take_along_axis(gids, np.asarray(pos), -1))


@pytest.mark.parametrize("slab_dtype", ["fp32", "int8"])
def test_one_process_sharded_head_is_the_lss_head(slab_dtype):
    w, _, q = _inputs(230, 1, seed=2)
    cfg = LSSConfig(k_bits=3, n_tables=2, slab_dtype=slab_dtype)
    eng = Engine(None, torch.from_numpy(w), None, cfg, top_k=6,
                 head="lss-sharded", buckets=(2, 8))
    eng.fit_random(torch.Generator().manual_seed(1))
    a = eng.rank(q)
    b = eng.rank(q, head="lss")
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert a.cand_ids is None
    assert eng._get_mesh().n_shards == 1
    assert eng.compile_counts == {("lss-sharded", 8): 1, ("lss", 8): 1}


def test_convert_carries_a_jax_stack_over():
    m, n_shards = 23, 3
    w, theta, q = _inputs(m, n_shards, seed=3)
    jcfg, cfg = _cfgs("int8")
    jstack, _, m_local = _jax_stack(w, theta, jcfg, n_shards)
    t = jstack.tables
    stack = lss_index_stack_from_numpy(
        jstack.theta, t.table_ids, t.n_dropped, jstack.w_bucketed,
        jstack.w_scale, t.k_bits, t.n_tables, t.capacity, device="cpu")
    assert len(stack) == n_shards
    for s, idx in enumerate(stack):
        np.testing.assert_array_equal(idx.tables.table_ids.numpy(),
                                      t.table_ids[s])
        np.testing.assert_array_equal(idx.w_bucketed.numpy(),
                                      jstack.w_bucketed[s])
        np.testing.assert_array_equal(idx.w_scale.numpy(), jstack.w_scale[s])
        assert idx.w_bucketed.dtype == torch.int8
    want_l, want_i, want_s, _ = _jax_oracle(q, jstack, None, n_shards,
                                            m_local, TOP_K)
    part = local_part(torch.from_numpy(q), stack, None, k=TOP_K, shard0=0,
                      m_local=m_local)
    lg, ids = topk_merge(part.logits, part.gids, TOP_K)
    np.testing.assert_array_equal(part.sample.numpy(), want_s)
    assert_close(lg, want_l, rtol=LOGIT_TOL, atol=LOGIT_TOL, what="logits")
    assert_topk_ids_equal(ids, want_i, want_l, LOGIT_TOL, what="ids")
