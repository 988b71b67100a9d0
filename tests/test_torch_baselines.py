"""Table 1's baselines in the port against the JAX package's
``benchmarks/baselines.py``, on the CPU, from the same numpy WOL and
queries (m = 512 neurons, d = 17).

The random choices cross as numpy: the hyperplanes of SLIDE, the k-means
starting rows of each PQ subspace and the ip-NSW entry points are the
ones the JAX key picks, handed to the port's deterministic builders.
Every case runs twice: with the default chunk size and with chunks of a
few rows (``CHUNK_ELEMS``), which must not change a result.

Tolerances:
* ``full_topk``, SLIDE (ids, sample), the ip-NSW graph and top-k ids, and
  ``pq_topk`` on JAX's own PQ index: exact;
* SLIDE's tables: exact on every neuron, queries on the rows whose hash
  margin exceeds 1e-5;
* ``pq_index`` against ``pq_build``: codebooks allclose at 1e-5, codes
  equal on >= 99% of the neurons (the k-means sums run in another order,
  so a neuron at a near-tie between two centroids may take either);
  ``pq_topk`` ids exact on the queries where both indexes rank alike.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import baselines as JB  # noqa: E402
from repro.core.lss import LSSConfig as JLSSConfig  # noqa: E402
from repro_torch.benchmarks import baselines as B  # noqa: E402
from repro_torch.core.lss import LSSConfig  # noqa: E402
from repro_torch.testing.parity import (assert_close,  # noqa: E402
                                        assert_ints_equal, margin_rows)

M, D, NQ, K = 512, 17, 64, 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small CPU ops: one intra-op thread, as in the trainer tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["default", "small"])
def chunks(request, monkeypatch):
    """The default chunk size, or chunks of a few rows."""
    if request.param == "small":
        monkeypatch.setattr(B, "CHUNK_ELEMS", 3 * M)
    return request.param


@pytest.fixture(scope="module")
def wol():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(M, D)) / np.sqrt(D)).astype(np.float32)
    b = (rng.normal(size=(M,)) * 0.1).astype(np.float32)
    q = rng.normal(size=(NQ, D)).astype(np.float32)
    return w, b, q


def _t(a):
    return torch.from_numpy(np.array(a))


def test_full_topk(wol, chunks):
    w, b, q = wol
    want, n = jax.jit(lambda q: JB.full_topk(q, jnp.asarray(w),
                                             jnp.asarray(b), K))(q)
    got, m = B.full_topk(_t(q), _t(w), _t(b), K)
    assert m == n == M and got.dtype == torch.int32
    assert_ints_equal(got, want, what="full_topk ids")


def test_slide(wol, chunks):
    w, b, q = wol
    jcfg = JLSSConfig(k_bits=5, n_tables=3)
    jindex = JB.slide_build(jax.random.PRNGKey(2), jnp.asarray(w),
                            jnp.asarray(b), jcfg)
    index = B.slide_index(_t(w), _t(b), _t(jindex.theta),
                          LSSConfig(k_bits=5, n_tables=3))
    assert_ints_equal(index.tables.table_ids, jindex.tables.table_ids,
                      what="SLIDE tables")
    want_ids, want_sample = JB.slide_topk(jnp.asarray(q), jindex, K)
    got_ids, got_sample = B.slide_topk(_t(q), index, K)
    rows = margin_rows(np.concatenate([q, np.zeros((NQ, 1), np.float32)],
                                      1), np.asarray(jindex.theta))
    assert rows.sum() > 0.9 * NQ
    assert_ints_equal(got_ids, want_ids, rows=rows, what="SLIDE ids")
    assert got_sample == pytest.approx(want_sample, rel=0, abs=0)
    # slide_build draws its own hyperplanes: same shapes, a working index
    own = B.slide_build(torch.Generator().manual_seed(0), _t(w), _t(b),
                        LSSConfig(k_bits=5, n_tables=3))
    assert own.theta.shape == (D + 1, 15)
    assert own.tables.table_ids.shape == index.tables.table_ids.shape


def _jax_pq_starts(key, m, n_subspaces=8, n_codes=256):
    """The rows ``benchmarks.baselines.pq_build`` starts each subspace's
    k-means from, for ``key``."""
    keys = jax.random.split(key, n_subspaces)
    return np.stack([np.asarray(jax.random.choice(
        k, m, (n_codes,), replace=m < n_codes)) for k in keys])


@pytest.mark.parametrize("n_iters", [0, 4])
def test_pq_index_and_topk(wol, chunks, n_iters):
    w, b, q = wol
    key = jax.random.PRNGKey(3)
    jpq = JB.pq_build(key, jnp.asarray(w), jnp.asarray(b), n_subspaces=8,
                      n_iters=n_iters)
    starts = _jax_pq_starts(key, M)
    pq = B.pq_index(_t(w), _t(b), _t(starts), n_iters)
    assert pq.codebooks.shape == jpq.codebooks.shape     # d padded 17 -> 24
    assert_close(pq.codebooks, np.asarray(jpq.codebooks), rtol=1e-5,
                 atol=1e-5, what="codebooks")
    same = (pq.codes.numpy() == np.asarray(jpq.codes)).all(1)
    assert same.mean() >= 0.99, same.mean()
    # pq_topk on JAX's own index: exact
    jidx = B.PQIndex(_t(jpq.codebooks), _t(jpq.codes), _t(jpq.bias))
    want, n = jax.jit(lambda q: JB.pq_topk(q, jpq, K))(q)
    got, m = B.pq_topk(_t(q), jidx, K)
    assert m == n == M
    assert_ints_equal(got, want, what="pq_topk ids on JAX's index")
    # and on the port's index, where both rank alike
    mine, _ = B.pq_topk(_t(q), pq, K)
    agree = (mine.numpy() == np.asarray(want)).all(1)
    assert agree.mean() >= 0.95, agree.mean()


def test_pq_build_starts():
    w = torch.randn(300, 16, generator=torch.Generator().manual_seed(0))
    pq = B.pq_build(torch.Generator().manual_seed(1), w, torch.zeros(300),
                    n_iters=0)
    # no k-means step: each codebook is 256 distinct rows of its subspace
    for j in range(8):
        cb = pq.codebooks[j]
        assert len({tuple(r) for r in cb.tolist()}) == 256
    # fewer rows than codes: drawn with replacement
    small = B.pq_build(torch.Generator().manual_seed(1), w[:100],
                       torch.zeros(100), n_iters=2)
    assert small.codebooks.shape == (8, 256, 2)
    assert small.codes.shape == (100, 8)


def test_ipnsw(wol, chunks):
    w, b, q = wol
    jnsw = JB.ipnsw_build(jax.random.PRNGKey(4), jnp.asarray(w),
                          jnp.asarray(b))
    nsw = B.ipnsw_index(_t(w), _t(b), _t(jnsw.entry))
    assert nsw.graph.dtype == torch.int32
    assert_ints_equal(nsw.graph, jnsw.graph, what="ip-NSW graph")
    want, jvisited = JB.ipnsw_topk(jnp.asarray(q), jnsw, K)
    got, visited = B.ipnsw_topk(_t(q), nsw, K)
    assert visited == jvisited == 8 + 12 * 32 * 16
    assert_ints_equal(got, want, what="ip-NSW ids")
    # ipnsw_build draws distinct entry points
    own = B.ipnsw_build(torch.Generator().manual_seed(0), _t(w), _t(b))
    assert len(set(own.entry.tolist())) == 8
    assert torch.equal(own.graph, nsw.graph)
