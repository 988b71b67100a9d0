"""The paper's pipeline end to end on the port: train the XC model, fit
LSS (Algorithm 1), serve (Algorithm 2).

* The JAX package's ``test_system.py`` on the port alone, at the same
  sizes and with the same thresholds.
* The whole slice against the JAX package: a tiny XC model trained a few
  steps in both from the same initial parameters and data (loss history
  rtol 1e-4), and both trained models served through ``lss_predict`` on
  indexes built from one θ drawn in JAX: tables equal, and the same top
  ids on the rows whose hash margin holds, away from near-ties (1e-4).
* The port's quickstart on the CPU, at a reduced step count.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lss as jlss  # noqa: E402
from repro.core import simhash as jsim  # noqa: E402
from repro.data.pipeline import ShardedBatchIterator as JIterator  # noqa: E402
from repro.models import xc as jxc  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.core import simhash  # noqa: E402
from repro_torch.core.iul import fit_lss  # noqa: E402
from repro_torch.core.lss import (LSSConfig, avg_sample_size,  # noqa: E402
                                  build_index, label_recall, lss_predict,
                                  precision_at_k, retrieve)
from repro_torch.core.topk import topk_lowest_index  # noqa: E402
from repro_torch.data.pipeline import ShardedBatchIterator  # noqa: E402
from repro_torch.data.synthetic import xc_dataset  # noqa: E402
from repro_torch.models import xc  # noqa: E402
from repro_torch.testing.parity import (assert_close,  # noqa: E402
                                        assert_ints_equal,
                                        assert_topk_ids_equal, margin_rows)
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run thousands of small CPU ops.  With one intra-op thread
    a test worker never waits on its own threads while other workers hold
    the cores: with eight, the quickstart test ran 4.6x faster alone but
    34x slower beside one other worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_paper_pipeline_end_to_end():
    cfg = xc.XCConfig("sys", input_dim=4000, hidden=48, output_dim=2000,
                      max_in=24, max_labels=4)
    data = xc_dataset(5, 1536, cfg.input_dim, cfg.output_dim, n_topics=32,
                      max_in=cfg.max_in, max_labels=cfg.max_labels)
    tc = TrainConfig(lr=5e-3, warmup_steps=20, total_steps=220,
                     weight_decay=0.0, ckpt_every=10 ** 9)
    tr = Trainer(lambda p, b: xc.loss(p, b, cfg),
                 lambda g: xc.init_params(g, cfg, "cpu"), tc, device="cpu")
    it = ShardedBatchIterator({"x": data.x, "labels": data.labels}, 256,
                              device="cpu")
    state, hist = tr.fit(torch.Generator().manual_seed(0), it, 220,
                         log_every=10 ** 9)
    assert hist[-1]["loss"] < 7.0                      # learned something

    with torch.no_grad():
        model = xc.XCModel.from_params(state.params, cfg)
        n_test = 256
        q_all = model.embed(torch.from_numpy(data.x))
        q_tr, q_te = q_all[n_test:], q_all[:n_test]
        lab = torch.from_numpy(data.labels)
        w, b = model.w_out.float(), model.b_out.float()
        lss_cfg = LSSConfig(k_bits=3, n_tables=2, iul_epochs=6,
                            iul_inner_steps=8, iul_lr=0.02)
        index, _ = fit_lss(torch.Generator().manual_seed(1), q_tr,
                           lab[n_test:], w, b, lss_cfg)

        # (2) learned beats random SimHash on label recall
        theta0 = simhash.init_hyperplanes(
            torch.Generator().manual_seed(9), cfg.hidden + 1, lss_cfg.k_bits,
            lss_cfg.n_tables, device="cpu")
        idx0 = build_index(simhash.augment_neurons(w, b), theta0, lss_cfg)
        q_aug = simhash.augment_queries(q_te)
        rec_learned = float(label_recall(retrieve(q_aug, index)[0],
                                         lab[:n_test]))
        rec_random = float(label_recall(retrieve(q_aug, idx0)[0],
                                        lab[:n_test]))
        assert rec_learned > rec_random, (rec_learned, rec_random)

        # (1) LSS accuracy close to full at a fraction of the neurons
        full_p1 = float(precision_at_k(
            topk_lowest_index(q_te @ w.T + b, 5)[1], lab[:n_test], 1))
        _, ids = lss_predict(q_te, index, None, top_k=5)
        lss_p1 = float(precision_at_k(ids, lab[:n_test], 1))
        assert lss_p1 > 0.5 * full_p1, (lss_p1, full_p1)

        # (3) compute reduction
        sample = float(avg_sample_size(retrieve(q_aug, index)[0]))
        assert sample < cfg.output_dim / 5, sample


CFG = dict(input_dim=600, hidden=24, output_dim=400, max_in=12,
           max_labels=4)
LSS = dict(k_bits=3, n_tables=2)
STEPS, BATCH, N_TEST, TOP_K = 12, 32, 64, 5


def test_slice_matches_jax():
    """Train in both packages, then serve both models on one θ."""
    jcfg, tcfg = jxc.XCConfig("slice", **CFG), xc.XCConfig("slice", **CFG)
    d = xc_dataset(13, 160, CFG["input_dim"], CFG["output_dim"],
                   n_topics=8, max_in=CFG["max_in"],
                   max_labels=CFG["max_labels"])
    data = {"x": d.x, "labels": d.labels}
    kw = dict(lr=5e-3, warmup_steps=3, total_steps=STEPS, weight_decay=0.01)
    init = jax.tree.map(np.asarray, jxc.init_params(jax.random.PRNGKey(0),
                                                    jcfg))

    jstate, jhist = jtrainer.Trainer(
        lambda p, b: jxc.loss(p, b, jcfg),
        lambda k: jax.tree.map(jnp.asarray, init),
        jtrainer.TrainConfig(**kw)).fit(jax.random.PRNGKey(0),
                                        JIterator(data, BATCH, seed=2),
                                        STEPS, log_every=1)
    state, hist = Trainer(
        lambda p, b: xc.loss(p, b, tcfg),
        lambda g: {("embed_table" if k == "embed" else k):
                   tensor_from_numpy(v, torch.device("cpu"))
                   for k, v in init.items()},
        TrainConfig(**kw), device="cpu").fit(
            torch.Generator(), ShardedBatchIterator(data, BATCH, seed=2,
                                                    device="cpu"),
            STEPS, log_every=1)
    assert len(hist) == len(jhist) == STEPS
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([h[key] for h in hist],
                                   [h[key] for h in jhist], rtol=1e-4)
    assert hist[-1]["loss"] < hist[0]["loss"]

    # the trained models' embeddings, served on one θ drawn in JAX
    jp = jstate.params
    x = jnp.asarray(d.x[:N_TEST])
    jq = jxc.embed(jp, x)
    theta = jsim.init_hyperplanes(jax.random.PRNGKey(3), CFG["hidden"] + 1,
                                  LSS["k_bits"], LSS["n_tables"])
    jw_aug = jsim.augment_neurons(jp["w_out"], jp["b_out"])
    jindex = jlss.build_index(jw_aug, theta, jlss.LSSConfig(**LSS))
    jlog, jids = jax.jit(lambda q: jlss.lss_predict(
        q, jindex, None, top_k=TOP_K + 1, impl="ref"))(jq)

    with torch.no_grad():
        model = xc.XCModel.from_params(state.params, tcfg)
        q = model.embed(torch.from_numpy(d.x[:N_TEST]))
        assert_close(q, jq, rtol=1e-4, atol=1e-6, what="embeddings")
        w_aug = simhash.augment_neurons(model.w_out, model.b_out)
        theta_t = torch.from_numpy(np.array(theta))
        index = build_index(w_aug, theta_t, LSSConfig(**LSS))
        assert margin_rows(w_aug, theta_t, 1e-5).all()
        assert_ints_equal(index.tables.table_ids, jindex.tables.table_ids,
                          what="table ids")
        _, ids = lss_predict(q, index, None, top_k=TOP_K)
    rows = margin_rows(simhash.augment_queries(q), theta_t, 1e-5)
    assert rows.mean() > 0.9
    n = assert_topk_ids_equal(ids, np.array(jids)[:, :TOP_K],
                              np.array(jlog)[:, :TOP_K], 1e-4, rows=rows,
                              next_logit=np.array(jlog)[:, TOP_K],
                              what="top ids")
    assert n > 0.5 * ids.numel()


def test_quickstart_runs_on_cpu(capsys):
    from repro_torch.examples import quickstart
    out = quickstart.main(["--device", "cpu", "--steps", "40"])
    assert [h["step"] for h in out["history"]] == [40]
    assert math.isfinite(out["history"][-1]["loss"])
    for head in ("full", "lss"):
        for k in ("P@1", "P@5"):
            assert 0.0 <= out[head][k] <= 1.0
    assert 0.0 < out["lss"]["label_recall"] <= 1.0
    assert 0 < out["lss"]["avg_sample_size"] < 4000
    assert "[iul] epoch 9:" in capsys.readouterr().out

