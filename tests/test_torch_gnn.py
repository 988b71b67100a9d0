"""The port's GCN (``repro_torch.models.gnn``) against the JAX package's,
JAX's weights carried over as numpy: ``forward``, ``loss`` and
``molecule_loss`` with their gradients within rtol = atol = 1e-5 (fp32;
``index_add_`` sums in another order than ``segment_sum``) at the reduced
config and on ``graph_dataset`` graphs; the neighbour sampler held by
validity (its draws are a ``torch.Generator``'s, not JAX's bits); plus
mirrors of the reference's GCN tests (``tests/test_gnn_recsys.py``) and
its smoke case (``tests/test_smoke_archs.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduced import reduced_model_cfg as j_reduced  # noqa: E402
from repro.models import gnn as JG  # noqa: E402
from repro_torch.configs.reduced import reduced_model_cfg  # noqa: E402
from repro_torch.data.synthetic import graph_dataset, to_csr  # noqa: E402
from repro_torch.models import gnn as G  # noqa: E402
from repro_torch.testing.parity import assert_close  # noqa: E402
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten  # noqa: E402

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(cfg_j=None, cfg_t=None):
    jcfg = cfg_j or j_reduced("gcn-cora")
    cfg = cfg_t or reduced_model_cfg("gcn-cora")
    jp = jax.tree.map(np.asarray, JG.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jp, cfg, tree_map(lambda a: torch.from_numpy(np.array(a)),
                                   jp)


def _grads(loss_fn, params):
    leaves, treedef = tree_flatten(params)
    leaves = [a.detach().clone().requires_grad_(True) for a in leaves]
    loss = loss_fn(tree_unflatten(treedef, leaves))
    return loss, torch.autograd.grad(loss, leaves)


def test_forward_loss_and_grads_match_jax():
    jcfg, jp, cfg, tp = _pair()
    g = graph_dataset(0, n_nodes=120, n_edges=500, d_feat=cfg.d_feat,
                      n_classes=cfg.n_classes)
    edges = np.concatenate([g["edges"], np.full((9, 2), -1, np.int32)])
    batch = {"x": g["x"], "edges": edges, "labels": g["train_labels"]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda p, b: JG.forward(p, b["x"], b["edges"], jcfg))(
        jp, jb)
    got = G.forward(tp, torch.from_numpy(g["x"]), torch.from_numpy(edges),
                    cfg)
    assert got.shape == (120, cfg.n_classes)
    assert_close(got, want, rtol=TOL, atol=TOL, what="forward")
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: JG.loss(p, b, jcfg)))(jp, jb)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = _grads(lambda p: G.loss(p, tb, cfg), tp)
    assert_close(loss, want_loss, rtol=TOL, atol=TOL, what="loss")
    for gr, w in zip(grads, jax.tree.leaves(want_g)):
        assert_close(gr, w, rtol=TOL, atol=TOL, what="grad")


def test_molecule_loss_matches_jax():
    kw = dict(d_feat=6, n_classes=5, readout="mean")
    jcfg, jp, cfg, tp = _pair(j_reduced("gcn-cora")._replace(**kw),
                              reduced_model_cfg("gcn-cora")._replace(**kw))
    rng = np.random.default_rng(3)
    batch = {"x": rng.standard_normal((4, 9, 6)).astype(np.float32),
             "edges": rng.integers(0, 9, (4, 14, 2)).astype(np.int32),
             "labels": rng.integers(0, 5, 4).astype(np.int32)}
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: JG.molecule_loss(p, b, jcfg)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = _grads(lambda p: G.molecule_loss(p, tb, cfg), tp)
    assert_close(loss, want_loss, rtol=TOL, atol=TOL, what="molecule loss")
    for gr, w in zip(grads, jax.tree.leaves(want_g)):
        assert_close(gr, w, rtol=TOL, atol=TOL, what="molecule grad")


def test_specs_and_init_mirror_jax():
    jcfg, _, cfg, _ = _pair()
    want = jax.tree_util.tree_leaves(
        JG.param_specs(jcfg), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    got, _ = tree_flatten(G.param_specs(cfg))
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    jp = JG.init_params(jax.random.PRNGKey(0), jcfg)
    tp = G.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    for leaf, t in zip(jax.tree.leaves(jp), tree_flatten(tp)[0]):
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
    assert cfg.param_count() == jcfg.param_count()


def test_gcn_matches_dense_adjacency():
    cfg = G.GCNConfig(name="t", n_layers=2, d_feat=8, d_hidden=16,
                      n_classes=4)
    params = G.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    n, e = 30, 80
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(n, 8, generator=gen)
    edges = torch.randint(0, n, (e, 2), generator=gen)
    out = G.forward(params, x, edges, cfg)
    a = torch.zeros(n, n).index_put_((edges[:, 1], edges[:, 0]),
                                     torch.ones(e), accumulate=True)
    dn = torch.diag((a.sum(1) + 1) ** -0.5)
    ah = dn @ (a + torch.eye(n)) @ dn
    h = x
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        h = ah @ h @ w + b
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
    assert_close(out, h, rtol=1e-4, atol=1e-4, what="dense adjacency")


def test_gcn_padding_invariance():
    """-1 padded edges must not change the result on real nodes."""
    cfg = G.GCNConfig(name="t", n_layers=2, d_feat=4, d_hidden=8,
                      n_classes=3)
    params = G.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(10, 4, generator=gen)
    edges = torch.randint(0, 10, (20, 2), generator=gen)
    padded = torch.cat([edges, torch.full((7, 2), -1)])
    assert_close(G.forward(params, x, padded, cfg),
                 G.forward(params, x, edges, cfg), rtol=1e-5, atol=1e-5,
                 what="padding")


def test_neighbor_sampler_validity():
    g = graph_dataset(0, n_nodes=200, n_edges=1000, d_feat=4, n_classes=5)
    indptr, indices = to_csr(g["edges"], 200)
    seeds = torch.from_numpy(np.random.default_rng(0).integers(
        0, 200, size=16).astype(np.int32))
    nbrs, edges = G.sample_block(torch.Generator().manual_seed(0),
                                 torch.from_numpy(indptr),
                                 torch.from_numpy(indices), seeds, 5)
    assert nbrs.shape == (16, 5) and edges.shape == (80, 2)
    for i, s in enumerate(seeds.tolist()):
        actual = set(indices[indptr[s]:indptr[s + 1]].tolist()) | {s}
        assert set(nbrs[i].tolist()) <= actual
    assert edges[:, 1].tolist() == np.repeat(seeds.numpy(), 5).tolist()


def test_isolated_nodes_self_loop():
    indptr = torch.tensor([0, 0, 2, 2], dtype=torch.int32)   # 0, 2 isolated
    indices = torch.tensor([0, 2], dtype=torch.int32)
    nbrs, _ = G.sample_block(torch.Generator().manual_seed(0), indptr,
                             indices, torch.tensor([0, 1, 2]), 4)
    assert nbrs[0].tolist() == [0] * 4 and nbrs[2].tolist() == [2] * 4
    assert set(nbrs[1].tolist()) <= {0, 2}


def test_sampled_subgraph_validity():
    """Every local edge (neighbour position -> node position) of a
    two-hop sample joins a node to one of its CSR neighbours (or to
    itself, for an isolated node)."""
    g = graph_dataset(1, n_nodes=150, n_edges=600, d_feat=4, n_classes=3)
    indptr, indices = to_csr(g["edges"], 150)
    seeds = torch.arange(0, 150, 19)
    nodes, edges = G.sampled_subgraph(
        torch.Generator().manual_seed(2), torch.from_numpy(indptr),
        torch.from_numpy(indices), seeds, (4, 3))
    b = seeds.shape[0]
    assert nodes.shape == (b * (1 + 4 + 4 * 3),)
    assert edges.shape == (b * (4 + 12), 2) and edges.dtype == torch.int32
    for src, dst in edges.tolist():
        s, t = int(nodes[src]), int(nodes[dst])
        assert s in set(indices[indptr[t]:indptr[t + 1]].tolist()) | {t}
    # a GCN runs on the block
    cfg = G.GCNConfig(name="t", d_feat=4, d_hidden=8, n_classes=3)
    params = G.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    out = G.forward(params, torch.from_numpy(g["x"])[nodes], edges, cfg)
    assert out.shape == (nodes.shape[0], 3) and bool(
        torch.isfinite(out).all())


def test_gcn_cora_smoke():
    cfg = reduced_model_cfg("gcn-cora")
    params = G.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(50, cfg.d_feat, generator=gen)
    edges = torch.randint(0, 50, (120, 2), generator=gen)
    ar = torch.arange(50)
    labels = torch.where(ar % 2 == 0, ar % cfg.n_classes, -1)
    loss, grads = _grads(lambda p: G.loss(
        p, {"x": x, "edges": edges, "labels": labels}, cfg), params)
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    out = G.forward(params, x, edges, cfg)
    assert out.shape == (50, cfg.n_classes) and bool(
        torch.isfinite(out).all())


def test_dense_adjacency_of_the_jax_forward():
    """The JAX and the port's aggregation on one graph with repeated
    edges and self edges: the same normalised sum."""
    jcfg, jp, cfg, tp = _pair()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((12, cfg.d_feat)).astype(np.float32)
    edges = np.concatenate([rng.integers(0, 12, (30, 2)),
                            [[3, 3], [3, 3], [4, 5], [4, 5]]]).astype(
        np.int32)
    want = JG._sym_norm_agg(jnp.asarray(x), jnp.asarray(edges), 12)
    got = G._sym_norm_agg(torch.from_numpy(x), torch.from_numpy(edges), 12)
    assert_close(got, want, rtol=TOL, atol=TOL, what="aggregation")
