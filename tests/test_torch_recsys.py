"""The port's recommenders (``repro_torch.models.recsys``: DeepFM, AutoInt,
DIEN, BERT4Rec) against the JAX package's, JAX's weights carried over as
numpy: logits, losses and every gradient within rtol = atol = 1e-5 (fp32,
sums in other orders) at the reduced configs; the specs; plus mirrors of
the reference's own recsys tests (``tests/test_gnn_recsys.py``) and its
smoke cases (``tests/test_smoke_archs.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduced import reduced_model_cfg as j_reduced  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro_torch.configs.reduced import reduced_model_cfg  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.testing.parity import assert_close  # noqa: E402
from repro_torch.utils.tree import (tree_flatten, tree_map,  # noqa: E402
                                    tree_unflatten)

TOL = 1e-5
CTR = ["deepfm", "autoint", "dien"]
J_INIT = {"deepfm": JR.init_deepfm, "autoint": JR.init_autoint,
          "dien": JR.init_dien}
INIT = {"deepfm": R.init_deepfm, "autoint": R.init_autoint,
        "dien": R.init_dien}
SPECS = {"deepfm": (JR.deepfm_specs, R.deepfm_specs),
         "autoint": (JR.autoint_specs, R.autoint_specs),
         "dien": (JR.dien_specs, R.dien_specs)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(params):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), params)


def _jax_params(init, cfg, seed=0):
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg))


def _batch(arch, cfg, b=16, seed=1):
    rng = np.random.default_rng(seed)
    y = (rng.random(b) < 0.3).astype(np.int32)
    if arch == "dien":
        hist = rng.integers(-1, cfg.vocab_per_field, (b, cfg.seq_len))
        hist[:, -3:] = -1                          # a padded tail
        return {"hist": hist.astype(np.int32),
                "target": rng.integers(0, cfg.vocab_per_field, b).astype(
                    np.int32), "labels": y}
    return {"ids": rng.integers(0, cfg.vocab_per_field,
                                (b, cfg.n_fields)).astype(np.int32),
            "labels": y}


def _logits(mod, arch, params, batch, cfg):
    if arch == "deepfm":
        return mod.deepfm_logits(params, batch["ids"], cfg)
    if arch == "autoint":
        return mod.autoint_logits(params, batch["ids"], cfg)
    return mod.dien_logits(params, {"hist": batch["hist"],
                                    "target": batch["target"]}, cfg)


def _bce(lg, y, lib):
    """The CTR loss of the JAX package's train cells (``_ctr_loss``)."""
    return lib.mean(lib.maximum(lg, 0 * lg) - lg * y
                    + lib.log1p(lib.exp(-lib.abs(lg))))


def _grads(loss_fn, params):
    leaves, treedef = tree_flatten(params)
    leaves = [a.detach().clone().requires_grad_(True) for a in leaves]
    loss = loss_fn(tree_unflatten(treedef, leaves))
    return loss, torch.autograd.grad(loss, leaves)


# ----------------------------------------------------------------- CTR --

@pytest.mark.parametrize("arch", CTR)
def test_ctr_logits_loss_and_grads_match_jax(arch):
    jcfg, cfg = j_reduced(arch), reduced_model_cfg(arch)
    jp = _jax_params(J_INIT[arch], jcfg)
    tp = _to_torch(jp)
    batch = _batch(arch, cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = jax.jit(lambda p, b: _logits(JR, arch, p, b, jcfg))(jp, jb)
    got = _logits(R, arch, tp, tb, cfg)
    assert got.shape == (16,) and got.dtype == torch.float32
    assert_close(got, want, rtol=TOL, atol=TOL, what=f"{arch} logits")

    def jloss(p):
        return _bce(_logits(JR, arch, p, jb, jcfg),
                    jb["labels"].astype(jnp.float32), jnp)

    want_loss, want_g = jax.jit(jax.value_and_grad(jloss))(jp)
    loss, grads = _grads(lambda p: _bce(_logits(R, arch, p, tb, cfg),
                                        tb["labels"].float(), torch), tp)
    assert_close(loss, want_loss, rtol=TOL, atol=TOL, what=f"{arch} loss")
    want_leaves = jax.tree.leaves(want_g)
    assert len(want_leaves) == len(grads)
    for g, w in zip(grads, want_leaves):
        assert_close(g, w, rtol=TOL, atol=TOL, what=f"{arch} grad")


@pytest.mark.parametrize("arch", CTR)
def test_ctr_specs_and_init_mirror_jax(arch):
    jcfg, cfg = j_reduced(arch), reduced_model_cfg(arch)
    jspec, tspec = SPECS[arch]
    want = jax.tree_util.tree_leaves(
        jspec(jcfg), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    got, _ = tree_flatten(tspec(cfg))
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    jp = J_INIT[arch](jax.random.PRNGKey(0), jcfg)
    tp = INIT[arch](torch.Generator().manual_seed(0), cfg, device="cpu")
    j_leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    t_leaves, _ = tree_flatten(tp)
    assert len(j_leaves) == len(t_leaves)
    for (path, leaf), t in zip(j_leaves, t_leaves):
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch", ["deepfm", "autoint"])
def test_ctr_arch_smoke(arch):
    cfg = reduced_model_cfg(arch)
    params = INIT[arch](torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch, cfg).items()}
    loss, grads = _grads(lambda p: _bce(_logits(R, arch, p, batch, cfg),
                                        batch["labels"].float(), torch),
                         params)
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    lg = _logits(R, arch, params, batch, cfg)
    assert lg.shape == (16,) and bool(torch.isfinite(lg).all())


def test_dien_smoke():
    cfg = reduced_model_cfg("dien")
    params = R.init_dien(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = _batch("dien", cfg, b=8)
    lg = R.dien_logits(params, {"hist": torch.from_numpy(b["hist"]),
                                "target": torch.from_numpy(b["target"])},
                       cfg)
    assert lg.shape == (8,) and bool(torch.isfinite(lg).all())


def test_embedding_bag_modes():
    table = torch.arange(20.0).reshape(10, 2)
    ids = torch.tensor([[0, 1, -1], [5, -1, -1]])
    assert R.embedding_bag(table, ids, "sum").tolist() == [[2, 4], [10, 11]]
    assert R.embedding_bag(table, ids, "mean").tolist() == [[1, 2], [10, 11]]
    assert R.embedding_bag(table, ids, "max").tolist() == [[2, 3], [10, 11]]
    with pytest.raises(ValueError):
        R.embedding_bag(table, ids, "median")


def test_embedding_bag_weights_match_jax():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((30, 4)).astype(np.float32)
    ids = rng.integers(-1, 30, (5, 6)).astype(np.int32)
    w = rng.random((5, 6)).astype(np.float32)
    for mode in ("sum", "mean", "max"):
        want = JR.embedding_bag(jnp.asarray(table), jnp.asarray(ids), mode,
                                jnp.asarray(w))
        got = R.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                              mode, torch.from_numpy(w))
        assert_close(got, want, rtol=TOL, atol=TOL, what=mode)


def test_fm_identity():
    """DeepFM's FM term 0.5*((sum v)^2 - sum v^2) == sum_{i<j} <v_i, v_j>,
    as the port computes it."""
    v = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 5, 8)))
    want = sum(float(v[0, i] @ v[0, j])
               for i in range(5) for j in range(i + 1, 5))
    s = v.sum(1)
    got = 0.5 * (s.square() - v.square().sum(1)).sum(-1)
    assert abs(want - float(got)) < 1e-9


def test_augru_attention_gating():
    """AUGRU with zero attention keeps the initial (zero) state."""
    cfg = R.CTRConfig(name="t", kind="dien", n_fields=1, vocab_per_field=50,
                      embed_dim=4, seq_len=6, gru_dim=8, mlp_dims=(8,))
    params = R.init_dien(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.randn(2, 6, 8, generator=torch.Generator().manual_seed(1))
    h_zero = R._gru_scan(x, params["augru"], 8, att=torch.zeros(2, 6))
    assert float(h_zero.abs().max()) == 0.0
    h_one = R._gru_scan(x, params["augru"], 8, att=torch.ones(2, 6))
    assert float(h_one.abs().max()) > 0.0
    assert torch.equal(h_one, R._gru_scan(x, params["augru"], 8))


def test_gru_scan_matches_jax():
    jcfg = j_reduced("dien")
    jp = _jax_params(JR.init_dien, jcfg)
    x = np.random.default_rng(4).standard_normal(
        (3, 7, jcfg.gru_dim)).astype(np.float32)
    att = np.random.default_rng(5).random((3, 7)).astype(np.float32)
    want = JR._gru_scan(jnp.asarray(x), jp["augru"], jcfg.gru_dim,
                        jnp.asarray(att))
    got = R._gru_scan(torch.from_numpy(x), _to_torch(jp["augru"]),
                      jcfg.gru_dim, torch.from_numpy(att))
    assert_close(got, want, rtol=TOL, atol=TOL, what="augru")


# ------------------------------------------------------------ BERT4Rec --

@pytest.fixture(scope="module")
def b4r():
    jcfg, cfg = j_reduced("bert4rec"), reduced_model_cfg("bert4rec")
    jp = _jax_params(JR.init_bert4rec, jcfg)
    rng = np.random.default_rng(2)
    seq = rng.integers(0, cfg.n_items, (4, cfg.seq_len)).astype(np.int32)
    seq[1, -5:] = -1                                 # a padded row
    labels = np.where(rng.random(seq.shape) < 0.2, seq, -1).astype(np.int32)
    labels[seq < 0] = -1
    return jcfg, jp, cfg, _to_torch(jp), seq, labels


def test_bert4rec_encode_loss_and_grads_match_jax(b4r):
    jcfg, jp, cfg, tp, seq, labels = b4r
    want = jax.jit(lambda p, s: JR.bert4rec_encode(p, s, jcfg))(jp, seq)
    got = R.bert4rec_encode(tp, torch.from_numpy(seq), cfg)
    assert_close(got, want, rtol=TOL, atol=TOL, what="encode")
    batch = {"seq": seq, "labels": labels}
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p: JR.bert4rec_loss(p, batch, jcfg)))(jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = _grads(lambda p: R.bert4rec_loss(p, tb, cfg), tp)
    assert_close(loss, want_loss, rtol=TOL, atol=TOL, what="cloze loss")
    for g, w in zip(grads, jax.tree.leaves(want_g)):
        assert_close(g, w, rtol=TOL, atol=TOL, what="bert4rec grad")


def test_retrieval_scores_match_jax(b4r):
    jcfg, jp, cfg, tp, seq, _ = b4r
    hid = np.array(JR.bert4rec_encode(jp, seq, jcfg))[:, -1]
    cands = np.array([5, 0, 17, 1999], np.int32)
    for c in (None, cands):
        want = JR.retrieval_scores(jp, hid, None if c is None else c)
        got = R.retrieval_scores(tp, torch.from_numpy(hid),
                                 None if c is None else torch.from_numpy(c))
        assert_close(got, want, rtol=TOL, atol=TOL, what="scores")
    assert tuple(got.shape) == (4, 4)


def test_bert4rec_specs_and_init_mirror_jax():
    jcfg, cfg = j_reduced("bert4rec"), reduced_model_cfg("bert4rec")
    want = jax.tree_util.tree_leaves(
        JR.bert4rec_specs(jcfg), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    got, _ = tree_flatten(R.bert4rec_specs(cfg))
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    jp = JR.init_bert4rec(jax.random.PRNGKey(0), jcfg)
    tp = R.init_bert4rec(torch.Generator().manual_seed(0), cfg, device="cpu")
    for leaf, t in zip(jax.tree.leaves(jp), tree_flatten(tp)[0]):
        assert tuple(t.shape) == leaf.shape
    assert cfg.param_count() == jcfg.param_count()


def test_bert4rec_masking_semantics():
    cfg = R.Bert4RecConfig(name="t", n_items=100, embed_dim=16, n_blocks=1,
                           n_heads=2, seq_len=8)
    params = R.init_bert4rec(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    seq = torch.randint(0, 100, (2, 8),
                        generator=torch.Generator().manual_seed(1))
    # padded positions must not affect other positions' hidden states
    seq_pad = seq.clone()
    seq_pad[:, -2:] = -1
    seq_pad2 = seq.clone()                    # as the reference builds it
    seq_pad2[:, -2:] = -1
    seq_pad2[:, -1] = -1
    h1 = R.bert4rec_encode(params, seq_pad, cfg)
    h2 = R.bert4rec_encode(params, seq_pad2, cfg)
    assert_close(h1[:, :6], h2[:, :6], rtol=1e-4, atol=1e-5, what="pad")


def test_bert4rec_smoke():
    cfg = reduced_model_cfg("bert4rec")
    params = R.init_bert4rec(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    g = torch.Generator().manual_seed(1)
    seq = torch.randint(0, cfg.n_items, (4, cfg.seq_len), generator=g)
    labels = torch.where(torch.rand(seq.shape, generator=g) < 0.2, seq, -1)
    loss, grads = _grads(lambda p: R.bert4rec_loss(
        p, {"seq": seq, "labels": labels}, cfg), params)
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(gr).all()) for gr in grads)
    hid = R.bert4rec_encode(params, seq, cfg)
    scores = R.retrieval_scores(params, hid[:, -1])
    assert scores.shape == (4, cfg.n_items)
    assert bool(torch.isfinite(scores).all())
