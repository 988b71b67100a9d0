"""The port's MoE layer (``repro_torch.models.moe``) and the MoE half of
its transformer against the JAX package's, on numpy-seeded inputs and
JAX's weights carried over by ``transformer_params_from_numpy``:
``router_topk``, ``dispatch_indices`` and ``moe_ffn`` (one dispatch group
and two) within rtol = atol = 2e-5 (integer outputs exact); ``lm_loss``
with its gradient, ``forward``, ``prefill``, ``decode_step`` and
``decode_step_pooled`` within 1e-4 (two fp32 layers, sums in other
orders) at ``tests/test_transformer.py``'s moe-shared and moe-parallel
configs; ``param_specs``; the convert round trip; plus the reference's
own MoE properties (counterpart of the MoE parts of ``tests/test_layers.py``
and ``tests/test_transformer.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.convert import (tensor_from_numpy,  # noqa: E402
                                 transformer_params_from_numpy)
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.testing.parity import assert_close  # noqa: E402
from repro_torch.utils.tree import tree_flatten, tree_unflatten  # noqa: E402

RTOL = ATOL = 2e-5   # one MoE layer in fp32, sums in other orders
TOL = 1e-4           # two fp32 transformer layers (as the dense tests)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # one intra-op thread, as the trainer tests pin it (eight OpenMP
    # threads a worker under pytest -n 6 crawl)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moe_cfgs(E, Ep, k, cf, groups=1):
    kw = dict(n_experts=E, top_k=k, d_model=16, d_ff=24,
              n_experts_padded=Ep, capacity_factor=cf, n_groups=groups)
    return JM.MoEConfig(**kw), M.MoEConfig(**kw)


def _moe_params(jcfg, seed=0):
    jp = jax.tree.map(np.asarray,
                      JM.init_moe_params(jax.random.PRNGKey(seed), jcfg))
    return jp, {k: torch.from_numpy(v.copy()) for k, v in jp.items()}


def _x(t, d=16, seed=1):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(
        np.float32)


# ------------------------------------------------------------ routing --

@pytest.mark.parametrize("E,Ep,k", [(6, 8, 2), (60, 64, 4), (16, 16, 2)])
def test_router_topk_matches_jax(E, Ep, k):
    jcfg, cfg = _moe_cfgs(E, Ep, k, 1.25)
    jp, tp = _moe_params(jcfg)
    x = _x(40)
    je, jpr, jaux = JM.router_topk(jnp.asarray(x), jp["router"], jcfg)
    te, tpr, taux = M.router_topk(torch.from_numpy(x), tp["router"], cfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert_close(tpr, jpr, rtol=RTOL, atol=ATOL, what="combine weights")
    assert_close(taux, jaux, rtol=RTOL, atol=ATOL, what="aux")
    assert int(te.max()) < E                     # pads never win


def test_router_ties_go_to_the_lowest_expert():
    _, cfg = _moe_cfgs(4, 4, 2, 1.25)
    w = torch.zeros(16, 4)                       # every logit equal
    top_e, top_p, _ = M.router_topk(torch.ones(3, 16), w, cfg)
    assert top_e.tolist() == [[0, 1]] * 3
    assert torch.allclose(top_p, torch.full((3, 2), 0.5))


@pytest.mark.parametrize("capacity", [1, 3, 8])
def test_dispatch_indices_matches_jax(capacity):
    rng = np.random.default_rng(capacity)
    top_e = rng.integers(0, 5, (2, 12, 2)).astype(np.int32)   # 2 groups
    for groups in (top_e[0], top_e):
        if groups.ndim == 3:
            jpos, jkeep = jax.vmap(JM.dispatch_indices,
                                   in_axes=(0, None, None))(
                jnp.asarray(groups), 5, capacity)
        else:
            jpos, jkeep = JM.dispatch_indices(jnp.asarray(groups), 5,
                                              capacity)
        pos, keep = M.dispatch_indices(torch.from_numpy(groups), 5,
                                       capacity)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))


def test_dispatch_indices_capacity_and_order():
    top_e = torch.tensor([[0, 1], [0, 1], [0, 2], [0, 2]])   # expert 0: 4x
    pos, keep = M.dispatch_indices(top_e, n_experts=4, capacity=2)
    posn, keepn = pos.numpy(), keep.numpy()
    # expert 0 gets exactly 2 kept slots (first-come by stable sort)
    kept0 = [i for i in range(0, 8, 2) if keepn[i]]
    assert kept0 == [0, 2]
    assert sorted(posn[kept0].tolist()) == [0, 1]
    kept_pos = posn[keepn]
    assert len(set(kept_pos.tolist())) == len(kept_pos)
    assert (posn[~keepn] == 4 * 2).all()         # the trash slot


# -------------------------------------------------------------- moe_ffn --

@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("cf", [0.5, 8.0])       # drops / no drops
def test_moe_ffn_matches_jax(groups, cf):
    jcfg, cfg = _moe_cfgs(6, 8, 2, cf, groups)
    jp, tp = _moe_params(jcfg)
    x = _x(40)
    jout, jaux = jax.jit(lambda xx, p: JM.moe_ffn(xx, p, jcfg))(
        jnp.asarray(x), jp)
    out, aux = M.moe_ffn(torch.from_numpy(x), tp, cfg)
    assert_close(out, jout, rtol=RTOL, atol=ATOL, what="moe_ffn")
    assert_close(aux, jaux, rtol=RTOL, atol=ATOL, what="aux")


def test_moe_ffn_groups_that_do_not_divide_fall_back_to_one():
    jcfg, cfg = _moe_cfgs(6, 8, 2, 1.25, groups=3)
    _, tp = _moe_params(jcfg)
    x = torch.from_numpy(_x(40))                 # 3 does not divide 40
    one, _ = M.moe_ffn(x, tp, cfg._replace(n_groups=1))
    assert torch.equal(M.moe_ffn(x, tp, cfg)[0], one)


def test_moe_matches_dense_oracle_with_big_capacity():
    jcfg, cfg = _moe_cfgs(6, 8, 2, 8.0)
    _, tp = _moe_params(jcfg)
    x = torch.from_numpy(_x(40))
    out, aux = M.moe_ffn(x, tp, cfg)
    want = M.moe_ffn_dense_oracle(x, tp, cfg)
    assert_close(out, want, rtol=2e-4, atol=2e-4, what="oracle")
    assert float(aux) > 0


def test_dense_oracle_matches_jax():
    jcfg, cfg = _moe_cfgs(6, 8, 2, 8.0)
    jp, tp = _moe_params(jcfg)
    x = _x(40)
    want = JM.moe_ffn_dense_oracle(jnp.asarray(x), jp, jcfg)
    got = M.moe_ffn_dense_oracle(torch.from_numpy(x), tp, cfg)
    assert_close(got, want, rtol=RTOL, atol=ATOL, what="dense oracle")


def test_moe_padded_experts_never_routed():
    jcfg, cfg = _moe_cfgs(3, 4, 2, 8.0)
    _, tp = _moe_params(jcfg)
    top_e, _, _ = M.router_topk(torch.from_numpy(_x(64, 16)), tp["router"],
                                cfg)
    assert int(top_e.max()) < 3


def test_init_moe_params_shapes_and_scales():
    _, cfg = _moe_cfgs(6, 8, 2, 1.25)
    p = M.init_moe_params(torch.Generator().manual_seed(0), cfg,
                          dtype=torch.bfloat16, device="cpu", n_layers=3)
    assert p["router"].shape == (3, 16, 8)
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].shape == p["w_up"].shape == (3, 8, 16, 24)
    assert p["w_down"].shape == (3, 8, 24, 16)
    assert p["w_gate"].dtype == torch.bfloat16
    # N(0, 1) * d**-0.5: std near 0.25; every expert drawn (none zero)
    assert abs(float(p["w_up"].float().std()) - 16 ** -0.5) < 0.03
    assert bool((p["w_down"].float().abs().sum((-1, -2)) > 0).all())


# ------------------------------------------------------ the transformer --

def _cfg(pkg, dtype, **kw):
    base = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=128, vocab=256, dtype=dtype,
                kv_chunk=16, q_chunk=64)
    base.update(kw)
    return pkg.TransformerConfig(**base)


STYLES = {
    "moe-shared": dict(moe_style="replace", n_experts=4, n_experts_padded=4,
                       moe_top_k=2, moe_d_ff=64, shared_expert_ff=96,
                       capacity_factor=4.0, qkv_bias=True),
    "moe-parallel": dict(moe_style="parallel", n_experts=4,
                         n_experts_padded=4, moe_top_k=2, moe_d_ff=64,
                         capacity_factor=4.0, tie_embeddings=True),
}


@pytest.fixture(scope="module", params=list(STYLES))
def model(request):
    kw = STYLES[request.param]
    jcfg, cfg = _cfg(JT, jnp.float32, **kw), _cfg(T, torch.float32, **kw)
    params = jax.tree.map(np.asarray,
                          JT.init_params(jax.random.PRNGKey(0), jcfg))
    return (jcfg, jax.tree.map(jnp.asarray, params), cfg,
            transformer_params_from_numpy(params, cfg, "cpu"), params)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_config_mirrors_jax(model):
    jcfg, _, cfg, _, _ = model
    assert cfg.moe_cfg._asdict() == jcfg.moe_cfg._asdict()
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def test_forward_loss_and_grads_match_jax(model):
    jcfg, jp, cfg, tp, _ = model
    toks = _tokens(2, 2, 17, cfg.vocab)
    labels = np.where(np.arange(17) % 5 == 0, -100, toks)
    batch = {"tokens": toks, "labels": labels}
    want_h, _, want_aux = jax.jit(lambda p, t: JT.forward(p, t, jcfg))(
        jp, toks)
    got_h, _, got_aux = T.forward(tp, torch.from_numpy(toks), cfg)
    assert_close(got_h, want_h, rtol=TOL, atol=TOL, what="forward")
    assert_close(got_aux, want_aux, rtol=TOL, atol=TOL, what="aux")
    assert float(got_aux) > 0
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, b, jcfg)))(jp, batch)
    leaves, treedef = tree_flatten(tp)
    leaves = [a.detach().clone().requires_grad_(True) for a in leaves]
    params = tree_unflatten(treedef, leaves)
    loss = T.lm_loss(params, {k: torch.from_numpy(v)
                              for k, v in batch.items()}, cfg)
    assert_close(loss, want_loss, rtol=TOL, atol=TOL, what="lm_loss")
    grads = torch.autograd.grad(loss, leaves)
    want_leaves = jax.tree.leaves(want_g)
    assert len(want_leaves) == len(grads)
    for got, want in zip(grads, want_leaves):
        assert_close(got, want, rtol=TOL, atol=TOL, what="grad")
    # every leaf learns, the experts and the router included
    assert all(float(g.abs().sum()) > 0 for g in grads)


def test_prefill_and_decode_step_match_jax(model):
    jcfg, jp, cfg, tp, _ = model
    toks = _tokens(5, 2, 17, cfg.vocab)
    jh, jc = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, 24))(jp, toks)
    th, tc = T.prefill(tp, torch.from_numpy(toks), cfg, max_len=24)
    assert_close(th, jh, rtol=TOL, atol=TOL, what="prefill hidden")
    assert_close(tc.k, jc.k, rtol=TOL, atol=TOL, what="prefill k")
    nxt = toks[:, 3]
    jh2, jc2 = jax.jit(lambda p, t, c: JT.decode_step(p, t, c, jcfg))(
        jp, nxt, jc)
    th2, tc2 = T.decode_step(tp, torch.from_numpy(nxt), tc, cfg)
    assert_close(th2, jh2, rtol=TOL, atol=TOL, what="decode_step")
    assert_close(tc2.v, jc2.v, rtol=TOL, atol=TOL, what="decode v")
    assert tc2.length == 18 and tc2.k is tc.k        # written in place


def test_decode_step_pooled_matches_jax(model):
    jcfg, jp, cfg, tp, _ = model
    rng = np.random.default_rng(6)
    b, s = 3, 16
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tok = rng.integers(0, cfg.vocab, b).astype(np.int32)
    lengths = np.array([0, 7, s], np.int32)
    jh, jk, _ = jax.jit(lambda p, *a: JT.decode_step_pooled(p, *a, jcfg))(
        jp, tok, k, v, lengths)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    th, _, _ = T.decode_step_pooled(tp, torch.from_numpy(tok), tk, tv,
                                    torch.from_numpy(lengths), cfg)
    assert_close(th, jh, rtol=TOL, atol=TOL, what="pooled hidden")
    assert_close(tk, jk, rtol=TOL, atol=TOL, what="pooled k")


def test_decode_rows_are_independent_at_eight_slots(model):
    """At <= 8 rows no expert is over its capacity (max(8, ...)), so a
    row's hidden does not depend on the other rows: row 0 alone and in a
    batch of 8 agree (the interleaved decode's premise)."""
    _, _, cfg, tp, _ = model
    rng = np.random.default_rng(9)
    shape = (cfg.n_layers, 8, 16, cfg.n_kv_heads, cfg.head_dim)
    k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, 8).astype(np.int64))
    lengths = torch.full((8,), 5)
    h8, _, _ = T.decode_step_pooled(tp, tok, k.clone(), v.clone(), lengths,
                                    cfg)
    h1, _, _ = T.decode_step_pooled(tp, tok[:1], k[:, :1].clone(),
                                    v[:, :1].clone(), lengths[:1], cfg)
    assert_close(h1, h8[:1], rtol=1e-5, atol=1e-5, what="row 0")


def test_param_specs_match_jax(model):
    jcfg, _, cfg, _, _ = model
    got, want = T.param_specs(cfg), JT.param_specs(jcfg)
    g_leaves, g_def = tree_flatten(got)
    w_flat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    assert len(g_leaves) == len(w_flat)
    for spec, (_, jspec) in zip(g_leaves, w_flat):
        assert tuple(spec) == tuple(jspec)
    assert set(got["layers"]["moe"]) == {"router", "w_gate", "w_up",
                                         "w_down"}


def test_moe_fsdp_specs_match_jax():
    kw = dict(STYLES["moe-parallel"], moe_fsdp=True)
    got = T.param_specs(_cfg(T, torch.float32, **kw))["layers"]["moe"]
    want = JT.param_specs(_cfg(JT, jnp.float32, **kw))["layers"]["moe"]
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}


def test_init_params_shapes_and_dtypes_mirror_jax(model):
    jcfg, _, cfg, _, _ = model
    jp = JT.init_params(jax.random.PRNGKey(0),
                        jcfg._replace(dtype=jnp.bfloat16))
    tp = T.init_params(torch.Generator().manual_seed(0),
                       cfg._replace(dtype=torch.bfloat16), device="cpu")
    j_leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    t_leaves, _ = tree_flatten(tp)
    assert len(j_leaves) == len(t_leaves)
    for (path, leaf), t in zip(j_leaves, t_leaves):
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path


def test_convert_round_trips(model):
    _, _, cfg, tp, params = model
    j_leaves = jax.tree.leaves(params)
    t_leaves, _ = tree_flatten(tp)
    for a, t in zip(j_leaves, t_leaves):
        assert np.array_equal(t.numpy(), a)
    bf = tensor_from_numpy(jnp.asarray(params["layers"]["moe"]["w_up"],
                                       jnp.bfloat16), torch.device("cpu"))
    assert bf.dtype == torch.bfloat16
    assert np.array_equal(bf.float().numpy(), np.asarray(
        jnp.asarray(params["layers"]["moe"]["w_up"], jnp.bfloat16),
        np.float32))


def test_convert_checks_the_moe_tree(model):
    _, _, cfg, _, params = model
    bad = jax.tree.map(lambda a: a, params)
    bad["layers"]["moe"]["w_gate"] = bad["layers"]["moe"]["w_gate"][:, :3]
    with pytest.raises(ValueError, match="w_gate"):
        transformer_params_from_numpy(bad, cfg, "cpu")
    gone = jax.tree.map(lambda a: a, params)
    del gone["layers"]["moe"]
    with pytest.raises(ValueError, match="layers.moe"):
        transformer_params_from_numpy(gone, cfg, "cpu")
    with pytest.raises(ValueError, match="layers.moe"):
        transformer_params_from_numpy(params, cfg._replace(moe_style="none"),
                                      "cpu")


def test_reduced_moe_archs_train_and_decode():
    """The reduced qwen2-moe-a2.7b and arctic-480b configs: a finite loss
    whose gradient reaches every leaf, prefill, one decode step and the
    head (the port's mirror of ``tests/test_smoke_archs.py``'s LM case)."""
    from repro_torch.configs.reduced import reduced_model_cfg
    for arch in ("qwen2-moe-a2.7b", "arctic-480b"):
        cfg = reduced_model_cfg(arch)
        tp = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
        toks = torch.from_numpy(_tokens(1, 2, 24, cfg.vocab))
        leaves, treedef = tree_flatten(tp)
        leaves = [a.requires_grad_(True) for a in leaves]
        loss = T.lm_loss(tree_unflatten(treedef, leaves),
                         {"tokens": toks, "labels": toks}, cfg)
        grads = torch.autograd.grad(loss, leaves)
        assert bool(torch.isfinite(loss)), arch
        assert all(bool(torch.isfinite(g).all()) for g in grads), arch
        with torch.no_grad():
            hidden, cache = T.prefill(tp, toks, cfg, max_len=32)
            assert hidden.shape == (2, 24, cfg.d_model)
            h, cache = T.decode_step(tp, toks[:, 0], cache, cfg)
            logits = T.logits_head(tp, h[:, None], cfg)
        assert logits.shape == (2, 1, cfg.vocab)
        assert bool(torch.isfinite(logits).all())
