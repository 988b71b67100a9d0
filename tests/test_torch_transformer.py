"""The port's decoder-only LM (``repro_torch.models.transformer``) against
the JAX package's (``repro.models.transformer``), the JAX weights carried
over by ``transformer_params_from_numpy``: ``forward``, ``lm_loss``,
``prefill``, ``decode_step``, ``decode_step_pooled`` and
``decode_step_paged`` within rtol = atol = 1e-4 at the reduced qwen2-0.5b
(QKV bias, tied embeddings) and qwen3-4b (qk-norm) configs in fp32; the
in-place cache writes; plus the reference's own properties (counterpart
of the dense parts of ``tests/test_transformer.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduced import reduced_model_cfg as j_reduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import qwen2_0_5b, qwen3_4b  # noqa: E402
from repro_torch.configs.reduced import reduced_model_cfg  # noqa: E402
from repro_torch.convert import transformer_params_from_numpy  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.testing.parity import assert_close  # noqa: E402

TOL = 1e-4           # 2 fp32 layers, sums in other orders
ARCHS = ["qwen2-0.5b", "qwen3-4b"]


def _jax_cfg(arch):
    return j_reduced(arch)


def _torch_cfg(arch):
    return reduced_model_cfg(arch)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """The reduced config in both packages, JAX's weights (with random
    QKV biases where the arch has them) in both."""
    arch = request.param
    jcfg, cfg = _jax_cfg(arch), _torch_cfg(arch)
    params = jax.tree.map(np.asarray,
                          JT.init_params(jax.random.PRNGKey(0), jcfg))
    if jcfg.qkv_bias:                         # zero at init: make them bite
        rng = np.random.default_rng(1)
        for n in ("bq", "bk", "bv"):
            params["layers"][n] = 0.1 * rng.standard_normal(
                params["layers"][n].shape).astype(np.float32)
    return (jcfg, jax.tree.map(jnp.asarray, params), cfg,
            transformer_params_from_numpy(params, cfg, "cpu"))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _np_cache(cache):
    return np.asarray(cache.k), np.asarray(cache.v)


# ------------------------------------------------------------ configs --

@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_config_mirrors_jax(arch):
    j, t = _jax_cfg(arch), _torch_cfg(arch)
    for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab", "qkv_bias", "qk_norm",
              "rope_base", "tie_embeddings", "kv_chunk", "q_chunk"):
        assert getattr(j, f) == getattr(t, f), f
    assert t.dtype == torch.float32
    assert t.param_count() == j.param_count()


def test_full_configs_mirror_jax():
    from repro.configs.registry import get_config
    for port in (qwen2_0_5b, qwen3_4b):
        spec = get_config(port.CONFIG.arch_id)
        j, t = spec.model_cfg, port.CONFIG.model_cfg
        assert t.param_count() == j.param_count()
        # norm_topk_prob is the port's alone; its default is the JAX routing
        fields = t._asdict()
        assert fields.pop("norm_topk_prob") is True
        assert fields | {"dtype": None} == j._asdict() | {"dtype": None}
        assert t.dtype == torch.bfloat16
        assert port.CONFIG.lss._asdict() == spec.lss._asdict()


def test_init_params_shapes_and_dtypes_mirror_jax():
    jcfg, cfg = _jax_cfg("qwen2-0.5b"), _torch_cfg("qwen2-0.5b")
    cfg = cfg._replace(dtype=torch.bfloat16)
    jp = JT.init_params(jax.random.PRNGKey(0),
                        jcfg._replace(dtype=jnp.bfloat16))
    tp = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(tp["layers"]) + 2          # + embed, final_norm
    for path, leaf in flat:
        keys = [p.key for p in path]
        t = tp[keys[0]] if len(keys) == 1 else tp[keys[0]][keys[1]]
        assert tuple(t.shape) == leaf.shape, keys
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), keys


# ------------------------------------------------------- against JAX --

def test_forward_and_loss_match_jax(model):
    jcfg, jp, cfg, tp = model
    toks = _tokens(2, 2, 33, cfg.vocab)           # 33 > kv_chunk: 2 chunks
    want, _, _ = jax.jit(lambda p, t: JT.forward(p, t, jcfg))(jp, toks)
    got, _, aux = T.forward(tp, torch.from_numpy(toks), cfg)
    assert_close(got, want, rtol=TOL, atol=TOL, what="forward")
    assert float(aux) == 0.0
    labels = np.where(np.arange(33) % 5 == 0, -100, toks)   # some masked
    batch = {"tokens": toks, "labels": labels}
    want_loss = jax.jit(lambda p, b: JT.lm_loss(p, b, jcfg))(jp, batch)
    got_loss = T.lm_loss(tp, {k: torch.from_numpy(v) for k, v in
                              batch.items()}, cfg)
    assert_close(got_loss, want_loss, rtol=TOL, atol=TOL, what="lm_loss")


def test_logits_head_and_gold_logit_match_jax(model):
    jcfg, jp, cfg, tp = model
    hidden = np.random.default_rng(3).standard_normal(
        (2, 3, cfg.d_model)).astype(np.float32)
    want = JT.logits_head(jp, hidden, jcfg)
    got = T.logits_head(tp, torch.from_numpy(hidden), cfg)
    assert_close(got, want, rtol=TOL, atol=TOL, what="logits_head")
    labels = np.random.default_rng(4).integers(0, cfg.vocab, (2, 3))
    assert_close(T.gold_logit(got, torch.from_numpy(labels)),
                 JT.gold_logit(want, labels), rtol=0, atol=0,
                 what="gold_logit")


def test_prefill_and_decode_step_match_jax(model):
    jcfg, jp, cfg, tp = model
    toks = _tokens(5, 2, 17, cfg.vocab)
    jh, jc = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, 24))(jp, toks)
    th, tc = T.prefill(tp, torch.from_numpy(toks), cfg, max_len=24)
    assert_close(th, jh, rtol=TOL, atol=TOL, what="prefill hidden")
    for got, want in zip((tc.k, tc.v), _np_cache(jc)):
        assert_close(got, want, rtol=TOL, atol=TOL, what="prefill cache")
    assert tc.length == 17 and tc.k.shape == jc.k.shape
    nxt = toks[:, 3]
    jh2, jc2 = jax.jit(lambda p, t, c: JT.decode_step(p, t, c, jcfg))(
        jp, nxt, jc)
    th2, tc2 = T.decode_step(tp, torch.from_numpy(nxt), tc, cfg)
    assert_close(th2, jh2, rtol=TOL, atol=TOL, what="decode_step")
    for got, want in zip((tc2.k, tc2.v), _np_cache(jc2)):
        assert_close(got, want, rtol=TOL, atol=TOL, what="decode cache")
    assert tc2.length == 18 and tc2.k is tc.k        # written in place


def _pool_inputs(cfg, b=3, s=16, seed=6):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tok = rng.integers(0, cfg.vocab, b).astype(np.int32)
    lengths = np.array([0, 7, s][:b], np.int32)     # empty, mid, full row
    return tok, k, v, lengths


def test_decode_step_pooled_matches_jax(model):
    jcfg, jp, cfg, tp = model
    tok, k, v, lengths = _pool_inputs(cfg)
    jh, jk, jv = jax.jit(
        lambda p, *a: JT.decode_step_pooled(p, *a, jcfg))(jp, tok, k, v,
                                                         lengths)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    th, tk2, tv2 = T.decode_step_pooled(tp, torch.from_numpy(tok), tk, tv,
                                        torch.from_numpy(lengths), cfg)
    assert tk2 is tk and tv2 is tv                    # in place
    assert_close(th, jh, rtol=TOL, atol=TOL, what="pooled hidden")
    assert_close(tk, jk, rtol=TOL, atol=TOL, what="pooled k")
    assert_close(tv, jv, rtol=TOL, atol=TOL, what="pooled v")
    # the full row (lengths == max_len) wrote nothing, not the last slot
    assert np.array_equal(tk[:, 2].numpy(), k[:, 2])
    # the other rows wrote exactly one position each
    changed = (tk.numpy() != k).any(axis=(0, 3, 4))
    assert changed[0].tolist() == [True] + [False] * 15
    assert np.flatnonzero(changed[1]).tolist() == [7]


def test_decode_step_paged_matches_jax_and_dense(model):
    jcfg, jp, cfg, tp = model
    b, w, p = 3, 16, 4
    tok, k, v, lengths = _pool_inputs(cfg, b, w)
    n_pp = w // p
    # scatter each row's dense slab into pages of a shuffled arena
    rng = np.random.default_rng(7)
    pids = 1 + rng.permutation(b * n_pp).reshape(b, n_pp).astype(np.int32)
    arena_shape = (cfg.n_layers, 1 + b * n_pp, p, cfg.n_kv_heads,
                   cfg.head_dim)
    ka = rng.standard_normal(arena_shape).astype(np.float32)   # stale
    va = rng.standard_normal(arena_shape).astype(np.float32)
    for i in range(b):
        for j in range(n_pp):
            ka[:, pids[i, j]] = k[:, i, j * p:(j + 1) * p]
            va[:, pids[i, j]] = v[:, i, j * p:(j + 1) * p]
    table = pids.copy()
    table[0, 1:] = 0                        # row 0 maps only its 1st page
    jh, jka, jva = jax.jit(lambda pr, *a: JT.decode_step_paged(
        pr, *a, jcfg, w))(jp, tok, ka, va, table, lengths)
    tka, tva = torch.from_numpy(ka.copy()), torch.from_numpy(va.copy())
    th, _, _ = T.decode_step_paged(tp, torch.from_numpy(tok), tka, tva,
                                   torch.from_numpy(table),
                                   torch.from_numpy(lengths), cfg, w)
    assert_close(th, jh, rtol=TOL, atol=TOL, what="paged hidden")
    # scratch page 0 takes writes from rows that must not write: compare
    # the real pages only
    assert_close(tka[:, 1:], np.asarray(jka)[:, 1:], rtol=TOL, atol=TOL,
                 what="paged k arena")
    assert_close(tva[:, 1:], np.asarray(jva)[:, 1:], rtol=TOL, atol=TOL,
                 what="paged v arena")
    # bit-identical to the dense layout on the same contents
    dh, _, _ = T.decode_step_pooled(
        tp, torch.from_numpy(tok), torch.from_numpy(k.copy()),
        torch.from_numpy(v.copy()), torch.from_numpy(lengths), cfg)
    assert torch.equal(th, dh)


# ------------------------------------------------------ own properties --

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    cfg = _torch_cfg(arch)
    tp = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.from_numpy(_tokens(1, 2, 17, cfg.vocab))
    hidden, cache = T.prefill(tp, toks, cfg, max_len=24)
    nxt = T.logits_head(tp, hidden[:, -1:], cfg)[:, 0].argmax(-1)
    h2, cache2 = T.decode_step(tp, nxt, cache, cfg)
    full, _, _ = T.forward(tp, torch.cat([toks, nxt[:, None]], 1), cfg)
    assert float((full[:, -1] - h2).abs().max()) < 1e-3
    assert cache2.length == 18


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_attends_through_the_op_and_training_does_not(arch):
    """A prefill sends each layer's attention to the ``prefill_attention``
    op (on the CPU its plain version, ``attention_blockwise`` at the
    config's chunks: the hidden state is the blockwise forward's, bit for
    bit); a training forward never calls it and still has a gradient."""
    cfg = _torch_cfg(arch)
    tp = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.from_numpy(_tokens(5, 2, 128, cfg.vocab))   # 2 q chunks

    def calls():
        return registry.dispatch_counts().get(("prefill_attention", "ref"), 0)

    before = calls()
    with torch.no_grad():
        hidden, _ = T.prefill(tp, toks, cfg, max_len=160)
        blockwise, _, _ = T.forward(tp, toks, cfg, mode="train")
    assert calls() == before + cfg.n_layers
    assert torch.equal(hidden, blockwise)
    wq = tp["layers"]["wq"].detach().requires_grad_(True)
    params = {**tp, "layers": {**tp["layers"], "wq": wq}}
    loss = T.lm_loss(params, {"tokens": toks, "labels": toks}, cfg)
    (grad,) = torch.autograd.grad(loss, [wq])
    assert calls() == before + cfg.n_layers
    assert float(grad.abs().sum()) > 0


def test_grads_flow_everywhere():
    cfg = _torch_cfg("qwen3-4b")._replace(qkv_bias=True)
    tp = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.from_numpy(_tokens(1, 2, 16, cfg.vocab))
    leaves = {"embed": tp["embed"], "final_norm": tp["final_norm"],
              **tp["layers"]}
    live = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
    params = {"embed": live["embed"], "final_norm": live["final_norm"],
              "lm_head": tp["lm_head"],
              "layers": {k: live[k] for k in tp["layers"]}}
    loss = T.lm_loss(params, {"tokens": toks, "labels": toks}, cfg)
    grads = torch.autograd.grad(loss, list(live.values()))
    for name, g in zip(live, grads):
        assert bool(torch.isfinite(g).all()), name
        assert float(g.abs().sum()) > 0, name


def test_convert_checks_the_tree():
    jcfg, cfg = _jax_cfg("qwen2-0.5b"), _torch_cfg("qwen2-0.5b")
    params = jax.tree.map(np.asarray,
                          JT.init_params(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="embed"):
        transformer_params_from_numpy(params, cfg._replace(vocab=7), "cpu")
    with pytest.raises(ValueError, match="lm_head"):
        transformer_params_from_numpy(
            params, cfg._replace(tie_embeddings=False), "cpu")
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                      params)
    tp = transformer_params_from_numpy(bf, cfg, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert np.array_equal(tp["embed"].float().numpy(),
                          np.asarray(bf["embed"], np.float32))
