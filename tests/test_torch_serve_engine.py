"""The port's serving engine on the CPU (counterpart of
``tests/test_serve_engine.py`` and ``tests/test_engine.py``): batcher
shape logic, one build per (head, bucket), single-pass metrics, the
request layer, ``WOLServer``, and parity with the JAX ``Engine``
(``impl="ref"``) on the same weights, hyperplanes and arrival pattern.

On the CPU a step runs eagerly; on the card it is a captured CUDA graph
(``tests/test_torch_cuda_kernels.py`` holds the two against each other).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.lss import LSSConfig as JLSSConfig  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro_torch.convert import lss_index_from_numpy  # noqa: E402
from repro_torch.core import simhash  # noqa: E402
from repro_torch.core.lss import (LSSConfig, avg_sample_size,  # noqa: E402
                                  dedup_mask, label_recall, retrieve)
from repro_torch.data.synthetic import xc_dataset  # noqa: E402
from repro_torch.models import xc  # noqa: E402
from repro_torch.serve import (HEAD_KINDS, Engine, MicroBatcher,  # noqa: E402
                               WOLServer)
from repro_torch.serve.step import Step  # noqa: E402
from repro_torch.testing.parity import (assert_close,  # noqa: E402
                                        assert_topk_ids_equal, margin_rows)

# the two packages' CPU GEMMs and dot products sum in other orders
LOGIT_RTOL = LOGIT_ATOL = 1e-5
TIE_TOL = 1e-5          # top ids exact where neighbours differ by more


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # the example trains and decodes on the CPU: one intra-op thread, as the trainer tests pin it (eight
    # OpenMP threads a worker under pytest -n 6 crawl)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w(m, d, seed=0):
    return np.random.default_rng(seed).standard_normal((m, d)).astype(
        np.float32)


def _engine(m=512, d=32, k_bits=4, n_tables=2, top_k=5, buckets=(1, 2, 4, 8),
            bucket_major=True, audit_rate=None):
    eng = Engine(None, torch.from_numpy(_w(m, d)), None,
                 LSSConfig(k_bits=k_bits, n_tables=n_tables,
                           use_bucket_major=bucket_major),
                 top_k=top_k, head="lss", buckets=buckets,
                 audit_rate=audit_rate)
    eng.fit_random(torch.Generator().manual_seed(1))
    return eng


def _queries(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


# ------------------------------------------------------------- batcher --

def test_batcher_bucket_ladder():
    b = MicroBatcher((1, 2, 4, 8))
    assert [b.bucket_for(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    with pytest.raises(ValueError):
        b.bucket_for(9)
    assert [(c.size, c.bucket) for c in b.plan(19)] == \
        [(8, 8), (8, 8), (3, 4)]
    assert b.plan(0) == []
    with pytest.raises(ValueError):
        MicroBatcher((0, 2))


def test_batcher_pad_rows():
    b = MicroBatcher((4,))
    x = {"a": np.ones((3, 5)), "b": np.arange(3)}
    p = b.pad_rows(x, 4)
    assert p["a"].shape == (4, 5) and p["b"].shape == (4,)
    assert p["a"][3].sum() == 0 and p["b"][3] == 0


# ------------------------------------------------ one build per bucket --

def test_no_recompile_across_arrival_patterns():
    eng = _engine(buckets=(1, 2, 4, 8))
    rng = np.random.default_rng(0)

    def drive(pattern):
        for n in pattern:
            for _ in range(n):
                eng.submit(rng.standard_normal(32).astype(np.float32))
            eng.flush()

    drive([3, 5, 2, 7, 1])
    assert all(v == 1 for v in eng.compile_counts.values())
    drive([7, 2, 3, 8, 8, 5, 1, 4, 6])
    for key, v in eng.compile_counts.items():
        assert v == 1, f"{key} rebuilt: {v} builds"
    assert all(k[0] == "lss" and k[1] in (1, 2, 4, 8)
               for k in eng.compile_counts)
    assert eng.metrics().n_compiles == len(eng.compile_counts)


def test_oversize_group_splits_into_max_buckets():
    eng = _engine(buckets=(4, 8))
    out = eng.rank(_queries(20, 32, 5), record=False)    # 8 + 8 + 4
    assert out.ids.shape == (20, 5) and out.ids.dtype == torch.int32
    assert set(eng.compile_counts) == {("lss", 8), ("lss", 4)}


def test_failed_build_is_retried_and_counted():
    """A build that raises (a malformed first batch) is not kept: the next
    call builds again, as a JAX trace that fails is retraced."""
    builds = []

    def fn(x):
        if x.shape[1] != 4:
            raise ValueError("bad width")
        return x * 2

    step = Step(fn, torch.device("cpu"), lambda: builds.append(1))
    with pytest.raises(ValueError):
        step(np.zeros((2, 3), np.float32))
    assert step(np.ones((2, 4), np.float32)).sum() == 16
    assert step(np.ones((2, 4), np.float32)).sum() == 16
    assert len(builds) == 2 and not step.captured


def test_lss_sharded_head_waits_for_its_slice():
    # the slice has come: the head exists, an unknown one still raises,
    # and a multihost engine refuses an embed_fn
    assert HEAD_KINDS == ("full", "lss", "lss-sharded")
    eng = Engine(None, torch.zeros(8, 4), head="lss-sharded")
    assert eng.default_head == "lss-sharded"
    with pytest.raises(ValueError, match="head must be one of"):
        Engine(None, torch.zeros(8, 4), head="lss-sharded-2")
    with pytest.raises(ValueError, match="embed_fn=None"):
        Engine(lambda b: b, torch.zeros(8, 4), spmd=object())


# ------------------------------------------------------------- parity --

def test_full_and_lss_agree_where_lss_retrieves_the_argmax():
    eng = _engine(m=256, d=16, k_bits=3)
    q = _queries(8, 16, 7)
    full = eng.rank(q, head="full", record=False)
    lss = eng.rank(q, head="lss", record=False)
    cand = lss.cand_ids.numpy()
    top1 = full.ids[:, 0].numpy()
    retrieved = [(top1[i] == cand[i]).any() for i in range(8)]
    assert any(retrieved), "degenerate test: no query retrieved its argmax"
    for i in range(8):
        if retrieved[i]:
            assert int(lss.ids[i, 0]) == int(top1[i])


def test_rank_accepts_1d_labels():
    eng = _engine(m=256, d=16)
    eng.reset_metrics()
    eng.rank(_queries(4, 16, 12), head="lss",
             labels=np.array([1, 2, 3, 4], np.int32))
    assert 0.0 <= eng.metrics().label_recall <= 1.0


def test_reset_metrics_keeps_pending_results():
    eng = _engine(m=256, d=16, buckets=(1, 2))
    rids = [eng.submit(np.zeros(16, np.float32)) for _ in range(3)]
    eng.reset_metrics()              # one group was auto-flushed already
    assert [r.rid for r in eng.flush()] == rids


def test_full_head_sample_size_is_m():
    eng = _engine(m=256, d=16)
    out = eng.rank(_queries(4, 16, 2), head="full", record=False)
    assert (out.sample_size.numpy() == 256).all()
    assert out.sample_size.dtype == torch.int32


# ------------------------------------------------------------ metrics --

def test_metrics_sample_size_matches_single_retrieval_pass():
    eng = _engine(m=512, d=32)
    q = _queries(8, 32, 3)
    eng.reset_metrics()
    out = eng.rank(q, head="lss")
    cand, _ = retrieve(simhash.augment_queries(torch.from_numpy(q)),
                       eng.index)
    # integer counts: the engine's sum of sample sizes is the distinct
    # candidates of one retrieval pass
    assert eng._sample_sum == int(dedup_mask(cand).sum())
    assert eng.metrics().avg_sample_size == int(dedup_mask(cand).sum()) / 8
    assert float(avg_sample_size(cand)) == pytest.approx(
        float(out.sample_size.float().mean()), rel=1e-6)


def test_metrics_label_recall_and_latency():
    eng = _engine(m=512, d=32)
    q = _queries(8, 32, 4)
    labels = np.random.default_rng(5).integers(0, 512, (8, 2)).astype(
        np.int32)
    eng.reset_metrics()
    out = eng.rank(q, head="lss", labels=labels)
    m = eng.metrics()
    want = float(label_recall(out.cand_ids, torch.from_numpy(labels)))
    assert m.label_recall == pytest.approx(want, rel=1e-6)
    assert m.n_requests == 8
    assert m.wall_s > 0 and m.throughput_rps > 0
    assert m.latency_p99_ms >= m.latency_p50_ms > 0


def test_metrics_nan_recall_without_labels():
    eng = _engine()
    eng.reset_metrics()
    eng.rank(np.zeros((2, 32), np.float32))
    assert math.isnan(eng.metrics().label_recall)


# ------------------------------------------------------ request layer --

def test_submit_flush_roundtrip_order_and_results():
    eng = _engine(m=256, d=16, buckets=(1, 2, 4))
    xs = _queries(11, 16, 1)
    rids = [eng.submit(xs[i]) for i in range(11)]
    res = eng.flush()
    assert [r.rid for r in res] == sorted(rids)
    assert all(r.ids.shape == (5,) for r in res)
    direct = eng.rank(xs, record=False)
    np.testing.assert_array_equal(np.stack([r.ids for r in res]),
                                  direct.ids.numpy())
    np.testing.assert_array_equal(np.stack([r.logits for r in res]),
                                  direct.logits.numpy())


def test_submit_batch_keeps_rids_contiguous_and_tensors_accepted():
    eng = _engine(m=256, d=16, buckets=(1, 2, 4))
    xs = torch.from_numpy(_queries(7, 16, 9))
    rids = eng.submit_batch(xs, labels=torch.arange(7))
    assert rids == list(range(7))
    res = eng.flush()
    # rank pads the tensor's last 3 rows to bucket 4 on their device
    for out in (eng.rank(xs, record=False),
                eng.rank(xs.numpy(), record=False)):
        np.testing.assert_array_equal(np.stack([r.ids for r in res]),
                                      out.ids.numpy())
        np.testing.assert_array_equal(np.stack([r.logits for r in res]),
                                      out.logits.numpy())


def test_wol_server_end_to_end():
    cfg = xc.XCConfig("t", input_dim=2000, hidden=32, output_dim=1000,
                      max_in=16, max_labels=4)
    data = xc_dataset(0, 512, cfg.input_dim, cfg.output_dim, n_topics=16,
                      max_in=16, max_labels=4)
    model = xc.XCModel(cfg, torch.Generator().manual_seed(0), device="cpu")
    server = WOLServer(lambda b: model.embed(b["x"]), model.w_out,
                       model.b_out,
                       LSSConfig(k_bits=4, n_tables=1, iul_epochs=2,
                                 iul_inner_steps=4, iul_lr=0.02),
                       top_k=5)
    batches = [{"x": torch.from_numpy(data.x[i * 128:(i + 1) * 128])}
               for i in range(3)]
    with pytest.raises(ValueError):
        server.serve(batches)                      # no index yet
    server.fit(torch.Generator().manual_seed(1), batches[:2],
               torch.from_numpy(data.labels[:256]))
    out_full, m_full = server.serve(batches, use_lss=False)
    out_lss, m_lss = server.serve(batches, use_lss=True)
    assert len(out_full) == len(out_lss) == 3
    assert out_lss[0][1].shape == (128, 5)
    assert m_full.avg_sample_size == cfg.output_dim
    assert 0 < m_lss.avg_sample_size < cfg.output_dim
    assert server.engine.calib is not None and server.index is not None


# ------------------------------------------- parity with the JAX Engine --

def _pair(m=512, d=32, k_bits=4, n_tables=2, buckets=(1, 2, 4, 8),
          bucket_major=True, head="lss"):
    """A JAX Engine (impl="ref") and the port's on the same w and the
    same JAX-drawn hyperplanes (index carried over as numpy)."""
    w = _w(m, d, seed=2)
    jeng = JEngine(None, jnp.asarray(w), None,
                   JLSSConfig(k_bits=k_bits, n_tables=n_tables,
                              use_bucket_major=bucket_major),
                   top_k=5, head=head, buckets=buckets, impl="ref")
    jeng.fit_random(jax.random.PRNGKey(1))
    ji = jeng.index
    teng = Engine(None, torch.from_numpy(w), None,
                  LSSConfig(k_bits=k_bits, n_tables=n_tables,
                            use_bucket_major=bucket_major),
                  top_k=5, head=head, buckets=buckets)
    teng._set_index(lss_index_from_numpy(
        np.array(ji.theta), np.array(ji.tables.table_ids),
        np.array(ji.tables.n_dropped),
        None if ji.w_bucketed is None else np.array(ji.w_bucketed),
        None, k_bits, n_tables, ji.tables.capacity, device="cpu"))
    return jeng, teng


@pytest.mark.parametrize("head,bucket_major", [("lss", True),
                                               ("lss", False),
                                               ("full", True)])
def test_engine_matches_jax_engine(head, bucket_major):
    """The same ragged submit pattern through both engines: ids exact
    (LSS on rows with hash margin, the full head away from near-ties),
    logits allclose, the metrics' sample size and recall equal."""
    jeng, teng = _pair(head=head, bucket_major=bucket_major)
    rng = np.random.default_rng(3)
    xs = _queries(90, 32, 4)
    labels = rng.integers(0, 512, (90, 3)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.3] = -1
    i = 0
    jres, tres = [], []
    while i < len(xs):
        n = int(rng.integers(1, 12))
        for j in range(i, min(i + n, len(xs))):
            jeng.submit(xs[j], labels=labels[j])
            teng.submit(xs[j], labels=labels[j])
        jres += jeng.flush()
        tres += teng.flush()
        i += n
    assert [r.rid for r in jres] == [r.rid for r in tres] == list(range(90))
    j_ids = np.stack([r.ids for r in jres])
    t_ids = np.stack([r.ids for r in tres])
    j_lg = np.stack([r.logits for r in jres])
    t_lg = np.stack([r.logits for r in tres])
    assert t_ids.dtype == np.int32 and t_lg.dtype == np.float32
    aug = np.concatenate([xs, np.zeros((90, 1), np.float32)], 1)
    rows = margin_rows(aug, teng.index.theta)
    if head == "lss":
        assert rows.all(), "the queries should keep a hash margin"
    assert_close(t_lg, j_lg, rtol=LOGIT_RTOL, atol=LOGIT_ATOL, rows=rows,
                 what="logits")
    n_checked = assert_topk_ids_equal(t_ids, j_ids, j_lg, TIE_TOL,
                                      rows=rows, what="ids")
    assert n_checked >= 0.99 * t_ids.size
    jm, tm = jeng.metrics(), teng.metrics()
    assert tm.n_requests == jm.n_requests == 90
    assert tm.avg_sample_size == jm.avg_sample_size
    assert tm.label_recall == jm.label_recall
    assert set(teng.compile_counts) == set(jeng.compile_counts)
    assert all(v == 1 for v in teng.compile_counts.values())


# ----------------------------------------------------------- example --

def test_serve_example_runs_on_cpu(capsys):
    from repro_torch.examples import serve_lss
    out = serve_lss.main(["--device", "cpu"])
    assert out["score"]["n_requests"] == 512
    assert 0 < out["score"]["avg_sample_size"] < 2000
    assert out["async"]["bit_identical"]
    assert out["async"]["n_completed"] == 192
    assert out["decode"]["loss"] < math.log(2048)     # below uniform
    assert 0 <= out["decode"]["agreement"] <= 1
    assert out["streaming"]["bit_identical"]
    assert out["streaming"]["n_decode_done"] == 12
    assert out["streaming"]["n_decode_tokens"] == 12 * 24
    assert out["sharded"] == {"n_shards": 1, "deterministic": True,
                              "local_shards": 2}
    printed = capsys.readouterr().out
    assert "bit-identical to synchronous flush: True" in printed
    assert "interleaved == blocking generate: True" in printed
