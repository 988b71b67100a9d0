"""The port's RNN language model and its data against the JAX package's
(``models/lstm.py``, ``data/synthetic.lm_dataset``, the ``WIKITEXT2``
setting), on the CPU, from the same numpy inputs.

Tolerances:
* ``lm_dataset``, parameter shapes and settings: exact;
* ``embed_seq`` and ``loss`` from the same parameters: atol = rtol = 1e-5
  (fp32; 9 steps x 2 layers of products summed in other orders);
* the loss's gradient in every parameter: atol = rtol = 1e-4;
* dropout: the kept share within 5 binomial standard deviations of
  ``1 - dropout``, and each kept unit exactly its value over
  ``1 - dropout``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import paper_datasets as jsettings  # noqa: E402
from repro.data.synthetic import lm_dataset as jlm_dataset  # noqa: E402
from repro.models import lstm as jlstm  # noqa: E402
from repro_torch.configs import paper_datasets as settings  # noqa: E402
from repro_torch.convert import lstm_params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import ShardedBatchIterator  # noqa: E402
from repro_torch.data.synthetic import lm_dataset  # noqa: E402
from repro_torch.models import lstm  # noqa: E402
from repro_torch.testing.parity import assert_close  # noqa: E402
from repro_torch.train.trainer import (TrainConfig, Trainer,  # noqa: E402
                                       value_and_grad)
from repro_torch.utils.tree import tree_flatten, tree_leaves  # noqa: E402

CFG = dict(vocab=64, hidden=16, n_layers=2)
SEQ = 9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small CPU ops: one intra-op thread, as in the trainer tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """JAX parameters with nonzero biases, converted, and a batch with
    one padded (-1) label."""
    jcfg = jlstm.LSTMConfig("tiny", **CFG)
    cfg = lstm.LSTMConfig("tiny", **CFG)
    jp = jlstm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    jp["layers"]["b"] = jnp.asarray(
        rng.normal(size=jp["layers"]["b"].shape).astype(np.float32) * 0.1)
    jp["b_out"] = jnp.asarray(
        rng.normal(size=jp["b_out"].shape).astype(np.float32) * 0.1)
    toks = rng.integers(0, CFG["vocab"], size=(5, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, 3] = -1
    params = lstm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jcfg, cfg, jp, batch, params, tbatch


def test_lm_dataset_equals_jax():
    for args in ((3, 3000, 800, 36), (5, 997, 64, 10, 4)):
        want = jlm_dataset(*args)
        got = lm_dataset(*args)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_config_and_params_match_jax():
    mine, ref = settings.WIKITEXT2, jsettings.WIKITEXT2
    assert (mine.name, mine.kind) == (ref.name, ref.kind)
    assert tuple(mine.lss) == tuple(ref.lss)
    assert tuple(mine.bench_lss) == tuple(ref.bench_lss)
    for size in ("full", "bench"):
        mine = getattr(settings.WIKITEXT2, size)
        ref = getattr(jsettings.WIKITEXT2, size)
        assert tuple(mine)[:5] == tuple(ref)[:5]
        assert mine.param_count() == ref.param_count()
    assert list(settings.ALL) == list(jsettings.ALL)
    cfg = lstm.LSTMConfig("tiny", **CFG)
    jp = jlstm.init_params(jax.random.PRNGKey(0),
                           jlstm.LSTMConfig("tiny", **CFG))
    p = lstm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    jleaves = jax.tree.leaves(jp)
    leaves, _ = tree_flatten(p)
    assert [tuple(x.shape) for x in leaves] == [x.shape for x in jleaves]
    assert sum(x.numel() for x in leaves) == cfg.param_count()
    assert all(x.dtype == torch.float32 for x in leaves)
    # N(0, 1) / sqrt(H) weights, zero biases
    assert not p["layers"]["b"].any() and not p["b_out"].any()
    assert abs(float(p["embed"].std()) * CFG["hidden"] ** 0.5 - 1) < 0.1


def test_embed_seq_and_loss_match_jax(case):
    jcfg, cfg, jp, batch, params, tbatch = case
    want_h = jax.jit(lambda p, t: jlstm.embed_seq(p, t, jcfg))(
        jp, batch["tokens"])
    got_h = lstm.embed_seq(params, tbatch["tokens"], cfg)
    assert got_h.shape == (5, SEQ, CFG["hidden"])
    assert_close(got_h, np.asarray(want_h), rtol=1e-5, atol=1e-5,
                 what="embed_seq")
    want = jax.jit(lambda p, b: jlstm.loss(p, b, jcfg))(jp, batch)
    got = lstm.loss(params, tbatch, cfg)
    assert_close(got, np.asarray(want), rtol=1e-5, atol=1e-5, what="loss")


def test_loss_gradient_matches_jax(case):
    jcfg, cfg, jp, batch, params, tbatch = case
    want = jax.jit(jax.grad(lambda p: jlstm.loss(p, batch, jcfg)))(jp)
    _, got = value_and_grad(lambda p, b: lstm.loss(p, b, cfg), params,
                            tbatch)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        assert_close(g, np.asarray(w), rtol=1e-4, atol=1e-4, what="grad")
        assert float(g.abs().max()) > 0


def test_dropout_keep_rate_and_scale():
    cfg = lstm.LSTMConfig("tiny", dropout=0.2, **CFG)
    params = lstm.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    tokens = torch.randint(0, CFG["vocab"], (64, SEQ),
                           generator=torch.Generator().manual_seed(2))
    plain = lstm.embed_seq(params, tokens, cfg)
    dropped = lstm.embed_seq(params, tokens, cfg,
                             torch.Generator().manual_seed(3))
    live = plain != 0
    kept = (dropped != 0) & live
    n = int(live.sum())
    rate = float(kept.sum()) / n
    sigma = (0.8 * 0.2 / n) ** 0.5
    assert abs(rate - 0.8) < 5 * sigma, rate
    torch.testing.assert_close(dropped[kept], plain[kept] / 0.8,
                               rtol=0, atol=0)
    assert not dropped[~kept].any()
    # another generator state draws another mask
    again = lstm.embed_seq(params, tokens, cfg,
                           torch.Generator().manual_seed(4))
    assert not torch.equal(again, dropped)


def test_trainer_trains_the_lstm():
    cfg = lstm.LSTMConfig("tiny", **CFG)
    toks = lm_dataset(3, 64 * 40, CFG["vocab"], SEQ + 1, n_topics=4)
    tc = TrainConfig(lr=1e-2, warmup_steps=2, total_steps=30,
                     weight_decay=0.0, ckpt_every=10 ** 9)
    tr = Trainer(lambda p, b: lstm.loss(p, b, cfg),
                 lambda g: lstm.init_params(g, cfg, "cpu"), tc,
                 device="cpu")
    it = ShardedBatchIterator({"tokens": toks[:, :-1],
                               "labels": toks[:, 1:]}, 32, device="cpu")
    state, hist = tr.fit(torch.Generator().manual_seed(0), it, 30,
                         log_every=10)
    assert [h["step"] for h in hist] == [10, 20, 30]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert np.isfinite([h["loss"] for h in hist]).all()
    assert set(state.params) == {"embed", "layers", "w_out", "b_out"}
