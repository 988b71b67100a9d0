"""The serving slice as a whole at small size, port against the JAX
package: the XC model's query embedding, the LSS index, Algorithm 2
(bucket-major and gather paths), retrieval and the paper's metrics.

The JAX model and index are carried across through ``repro_torch.convert``
(the frameworks draw different numbers from one seed); the data comes from
each package's own ``xc_dataset``, which must give identical arrays.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import paper_datasets as j_cfgs  # noqa: E402
from repro.core import lss as jlss  # noqa: E402
from repro.core import simhash as jsim  # noqa: E402
from repro.data.synthetic import xc_dataset as j_xc_dataset  # noqa: E402
from repro.models import xc as jxc  # noqa: E402
from repro_torch.configs import paper_datasets as t_cfgs  # noqa: E402
from repro_torch.convert import (lss_index_from_numpy,  # noqa: E402
                                 xc_params_from_numpy)
from repro_torch.core import lss as tlss  # noqa: E402
from repro_torch.core import simhash as tsim  # noqa: E402
from repro_torch.data.synthetic import xc_dataset  # noqa: E402
from repro_torch.testing.parity import (assert_close,  # noqa: E402
                                        assert_ints_equal,
                                        assert_topk_ids_equal, margin_rows)

IN, HID, OUT, MAX_IN, MAX_LAB = 2000, 32, 1500, 16, 4
LSS = dict(k_bits=4, n_tables=2, capacity=96)      # C = 192: quadratic
N, TOP_K = 64, 5


def _index_np(index):
    return dict(theta=np.array(index.theta),
                table_ids=np.array(index.tables.table_ids),
                n_dropped=np.array(index.tables.n_dropped),
                w_bucketed=(None if index.w_bucketed is None
                            else np.array(index.w_bucketed)),
                w_scale=None, k_bits=index.tables.k_bits,
                n_tables=index.tables.n_tables,
                capacity=index.tables.capacity)


@pytest.fixture(scope="module")
def jax_side():
    cfg = jxc.XCConfig("slice", IN, HID, OUT, MAX_IN, MAX_LAB)
    params = jxc.init_params(jax.random.PRNGKey(0), cfg)
    data = j_xc_dataset(3, N, IN, OUT, n_topics=16, max_in=MAX_IN,
                        max_labels=MAX_LAB)
    x, labels = jnp.array(data.x), jnp.array(data.labels)
    q = jxc.embed(params, x)
    w_aug = jsim.augment_neurons(params["w_out"], params["b_out"])
    theta = jsim.init_hyperplanes(jax.random.PRNGKey(1), HID + 1,
                                  LSS["k_bits"], LSS["n_tables"])
    index = jlss.build_index(w_aug, theta, jlss.LSSConfig(**LSS))
    gindex = jlss.build_index(w_aug, theta, jlss.LSSConfig(
        **LSS, use_bucket_major=False))
    fwd = jax.jit(functools.partial(jlss.lss_forward, top_k=TOP_K,
                                    impl="ref"))
    out = fwd(q, index, None)
    gout = fwd(q, gindex, w_aug)
    cand, buckets = jlss.retrieve(jsim.augment_queries(q), index, impl="ref")
    return dict(
        params={k: np.array(v) for k, v in params.items()},
        data=data, q=np.array(q), theta=np.array(theta),
        w_aug=np.array(w_aug),
        logits=np.array(jxc.logits(params, x)),
        loss=float(jxc.loss(params, {"x": x, "labels": labels}, cfg)),
        topk=np.array(jxc.predict_topk(params, x, TOP_K)),
        index=_index_np(index), gindex=_index_np(gindex),
        out=[np.array(a) for a in out], gout=[np.array(a) for a in gout],
        cand=np.array(cand), buckets=np.array(buckets),
        recall=float(jlss.label_recall(cand, labels)),
        p1=float(jlss.precision_at_k(out.top_ids, labels, 1)),
        p5=float(jlss.precision_at_k(out.top_ids, labels, 5)),
        sample=float(jlss.avg_sample_size(cand)),
    )


@pytest.fixture(scope="module")
def port(jax_side):
    model = xc_params_from_numpy(jax_side["params"], device="cpu")
    index = lss_index_from_numpy(**jax_side["index"], device="cpu")
    gindex = lss_index_from_numpy(**jax_side["gindex"], device="cpu")
    return model, index, gindex


def test_xc_dataset_identical(jax_side):
    d = xc_dataset(3, N, IN, OUT, n_topics=16, max_in=MAX_IN,
                   max_labels=MAX_LAB)
    np.testing.assert_array_equal(d.x, jax_side["data"].x)
    np.testing.assert_array_equal(d.labels, jax_side["data"].labels)
    assert d.x.dtype == np.int32 and d.n_topics == 16


def test_embed_logits_loss_close(jax_side, port):
    model, _, _ = port
    x = torch.from_numpy(jax_side["data"].x)
    labels = torch.from_numpy(jax_side["data"].labels)
    with torch.no_grad():
        assert_close(model.embed(x), jax_side["q"], rtol=1e-5, atol=1e-6,
                     what="embed")
        assert_close(model.logits(x), jax_side["logits"], rtol=1e-5,
                     atol=1e-6, what="logits")
        assert_close(model.loss({"x": x, "labels": labels}),
                     jax_side["loss"], rtol=1e-5, atol=1e-6, what="loss")
        assert_ints_equal(model.predict_topk(x, TOP_K), jax_side["topk"],
                          what="predict_topk")


def test_hash_margin_holds(jax_side):
    # every query and every neuron keeps |theta^T x_hat| > 1e-5, so all the
    # integer outputs below must agree exactly
    q_aug = np.concatenate([jax_side["q"], np.zeros((N, 1), np.float32)], 1)
    assert margin_rows(q_aug, jax_side["theta"]).all()
    assert margin_rows(jax_side["w_aug"], jax_side["theta"]).all()


@pytest.mark.parametrize("path", ["bucket_major", "gather"])
def test_lss_forward_matches(jax_side, port, path):
    _, index, gindex = port
    q = torch.from_numpy(jax_side["q"])
    if path == "bucket_major":
        got, want = tlss.lss_forward(q, index, None, TOP_K), jax_side["out"]
    else:
        got = tlss.lss_forward(q, gindex, torch.from_numpy(jax_side["w_aug"]),
                               TOP_K)
        want = jax_side["gout"]
    assert_ints_equal(got.cand_ids, want[3], what="cand_ids")
    assert_ints_equal(got.sample_size, want[2], what="sample_size")
    assert_close(got.top_logits, want[0], rtol=1e-5, atol=1e-5,
                 what="top_logits")
    assert_topk_ids_equal(got.top_ids, want[1], want[0], 1e-5, what="top_ids")
    logits, ids = tlss.lss_predict(q, index, None, TOP_K)
    assert torch.equal(ids, tlss.lss_forward(q, index, None, TOP_K).top_ids)


def test_retrieve_and_metrics_match(jax_side, port):
    _, index, _ = port
    q = torch.from_numpy(jax_side["q"])
    labels = torch.from_numpy(jax_side["data"].labels)
    cand, buckets = tlss.retrieve(tsim.augment_queries(q), index)
    assert_ints_equal(buckets, jax_side["buckets"], what="buckets")
    assert_ints_equal(cand, jax_side["cand"], what="cand")
    top_ids = tlss.lss_forward(q, index, None, TOP_K).top_ids
    assert float(tlss.label_recall(cand, labels)) == \
        pytest.approx(jax_side["recall"], abs=1e-7)
    assert float(tlss.precision_at_k(top_ids, labels, 1)) == \
        pytest.approx(jax_side["p1"], abs=1e-7)
    assert float(tlss.precision_at_k(top_ids, labels, 5)) == \
        pytest.approx(jax_side["p5"], abs=1e-7)
    assert float(tlss.avg_sample_size(cand)) == \
        pytest.approx(jax_side["sample"], abs=1e-4)
    assert torch.equal(tlss.dedup_mask(cand).sum(-1, dtype=torch.int32),
                       tlss.lss_forward(q, index, None, TOP_K).sample_size)


def test_port_build_index_matches(jax_side, port):
    _, index, _ = port
    w_aug = torch.from_numpy(jax_side["w_aug"])
    theta = torch.from_numpy(jax_side["theta"])
    own = tlss.build_index(w_aug, theta, tlss.LSSConfig(**LSS))
    assert own.tables[2:] == index.tables[2:]
    assert_ints_equal(own.tables.table_ids, index.tables.table_ids,
                      what="table_ids")
    assert_ints_equal(own.tables.n_dropped, index.tables.n_dropped,
                      what="n_dropped")
    assert_close(own.w_bucketed, index.w_bucketed, rtol=0, atol=0,
                 what="w_bucketed")
    assert own.w_scale is None
    q8 = tlss.build_index(w_aug, theta, tlss.LSSConfig(**LSS,
                                                       slab_dtype="int8"))
    assert q8.w_bucketed.dtype == torch.int8 and q8.w_scale.shape == \
        index.tables.table_ids.shape


@pytest.mark.parametrize("name", ["wiki10-31k", "delicious-200k", "text8"])
def test_paper_settings_match(name):
    j, t = j_cfgs.ALL[name], t_cfgs.ALL[name]
    assert t._fields == j._fields
    assert (t.name, t.kind) == (j.name, j.kind)
    # the port's XCConfig adds a torch dtype after the JAX fields
    for field in ("full", "bench"):
        assert tuple(getattr(t, field))[:6] == tuple(getattr(j, field))[:6]
    # the whole LSSConfig, IUL's fields included
    for field in ("lss", "bench_lss"):
        tl, jl = getattr(t, field), getattr(j, field)
        assert tl._fields == jl._fields
        assert tuple(tl) == tuple(jl)
    m = j.full.output_dim
    assert t.lss.resolve_capacity(m) == j.lss.resolve_capacity(m)


def test_delicious_capacity_is_808():
    cfg = t_cfgs.DELICIOUS
    assert cfg.lss.resolve_capacity(cfg.full.output_dim) == 808
