"""Algorithm 1 (IUL) and AdamW: the port against the JAX package on the
same numpy inputs (CPU), and the JAX package's IUL behaviour tests on the
port alone.

Tolerances: thresholds 1e-6; masks, ids and collision probabilities
exact; losses and gradients 1e-5; one AdamW step 1e-6; θ after an epoch
of Adam steps 1e-4 (each step adds the last bits of the gradient's
difference, amplified by Adam's normalisation).  The JAX side runs
jitted, with ``impl="ref"`` where it dispatches.  Its RNG draws are made
in JAX and handed over (the frameworks draw different numbers).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import iul as jiul  # noqa: E402
from repro.core import lss as jlss  # noqa: E402
from repro.core import simhash as jsim  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.convert import (adamw_state_from_numpy,  # noqa: E402
                                 lss_index_from_numpy)
from repro_torch.core import iul  # noqa: E402
from repro_torch.core import simhash  # noqa: E402
from repro_torch.core.lss import (LSSConfig, build_index,  # noqa: E402
                                  label_recall, retrieve)
from repro_torch.optim import (adamw_init, adamw_update,  # noqa: E402
                               clip_by_global_norm)
from repro_torch.testing.parity import (assert_close,  # noqa: E402
                                        assert_ints_equal, hash_margin,
                                        margin_rows)

M, D, N, NL = 400, 16, 64, 3
CFG = dict(k_bits=3, n_tables=2, iul_lr=0.02, iul_batch=16,
           iul_inner_steps=4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # fit_lss trains θ on the CPU: one intra-op thread, as the trainer tests pin it (eight
    # OpenMP threads a worker under pytest -n 6 crawl)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(t) for t in tree)
    return np.array(tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _index_np(index):
    return dict(theta=np.array(index.theta),
                table_ids=np.array(index.tables.table_ids),
                n_dropped=np.array(index.tables.n_dropped),
                w_bucketed=np.array(index.w_bucketed), w_scale=None,
                k_bits=index.tables.k_bits, n_tables=index.tables.n_tables,
                capacity=index.tables.capacity)


def _pairs_t(pairs):
    return iul.MinedPairs(*(_t(a) for a in pairs))


@pytest.fixture(scope="module")
def case():
    """Queries near their labels' neurons (so both pair kinds occur), and
    the JAX side's results on them."""
    rng = np.random.default_rng(11)
    w = rng.normal(size=(M, D)).astype(np.float32)
    labels = rng.integers(0, M, size=(N, NL)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.3] = -1
    labels[:, 0] = rng.integers(0, M, size=N)
    q = (0.8 * w[labels[:, 0]]
         + 0.6 * rng.normal(size=(N, D))).astype(np.float32)
    theta = rng.normal(size=(D + 1, 6)).astype(np.float32)
    cfg = jlss.LSSConfig(**CFG)
    w_aug = jsim.augment_neurons(jnp.asarray(w), None)
    q_aug = jsim.augment_queries(jnp.asarray(q))
    lab = jnp.asarray(labels)
    index = jax.jit(jlss.build_index, static_argnames=("cfg",))(
        w_aug, jnp.asarray(theta), cfg)
    t1, t2 = jax.jit(jiul.calibrate_thresholds, static_argnames=("cfg",))(
        q_aug, w_aug, lab, cfg)
    pairs = jax.jit(jiul.mine_pairs)(q_aug, lab, w_aug, index, t1, t2)
    loss, grad = jax.jit(jax.value_and_grad(jiul.iul_loss))(
        jnp.asarray(theta), q_aug, w_aug, pairs)
    cp, cn = jax.jit(jiul.collision_prob, static_argnums=(4, 5))(
        jnp.asarray(theta), q_aug, w_aug, pairs, CFG["k_bits"],
        CFG["n_tables"])
    return dict(w=w, q=q, labels=labels, theta=theta,
                w_aug=np.array(w_aug), q_aug=np.array(q_aug),
                index=_index_np(index), t1=float(t1), t2=float(t2),
                pairs=_np(tuple(pairs)), loss=float(loss),
                grad=np.array(grad), cp=float(cp), cn=float(cn))


@pytest.fixture(scope="module")
def port(case):
    return dict(q_aug=_t(case["q_aug"]), w_aug=_t(case["w_aug"]),
                labels=_t(case["labels"]), theta=_t(case["theta"]),
                index=lss_index_from_numpy(**case["index"], device="cpu"),
                pairs=_pairs_t(case["pairs"]), cfg=LSSConfig(**CFG))


def test_hash_margin_holds(case):
    # the retrieved sets match only where no query's hash bit is near 0
    assert margin_rows(case["q_aug"], case["theta"]).all()


def test_calibrate_thresholds_match(case, port):
    t1, t2 = iul.calibrate_thresholds(port["q_aug"], port["w_aug"],
                                      port["labels"], port["cfg"])
    assert abs(float(t1) - case["t1"]) <= 1e-6
    assert abs(float(t2) - case["t2"]) <= 1e-6
    assert float(t2) < float(t1)


def test_mine_pairs_match_exactly(case, port):
    pairs = iul.mine_pairs(port["q_aug"], port["labels"], port["w_aug"],
                           port["index"], torch.tensor(case["t1"]),
                           torch.tensor(case["t2"]))
    for name, got, want in zip(iul.MinedPairs._fields, pairs, case["pairs"]):
        assert_ints_equal(got, want, what=name)
    # both kinds of pairs occur, so the loss below sees both sides
    assert 0 < int(pairs.pos_mask.sum()) and 0 < int(pairs.neg_mask.sum())


def test_iul_loss_and_grad_match(case, port):
    args = (port["theta"], port["q_aug"], port["w_aug"], port["pairs"])
    loss, grad = iul.iul_loss_and_grad(*args)
    assert_close(loss, case["loss"], rtol=1e-5, atol=1e-5, what="loss")
    assert_close(grad, case["grad"], rtol=1e-5, atol=1e-5, what="grad")
    assert float(iul.iul_loss(*args)) == float(loss)
    # autograd is enabled inside, so a caller under no_grad still trains
    with torch.no_grad():
        _, g2 = iul.iul_loss_and_grad(*args)
    assert torch.equal(g2, grad) and not port["theta"].requires_grad


def _pair_rows(w_aug, pairs):
    return w_aug[pairs.pos_w.long()], w_aug[pairs.neg_w.long()]


def test_collision_prob_exact(case, port):
    cp, cn = iul.collision_prob(port["theta"], port["q_aug"],
                                *_pair_rows(port["w_aug"], port["pairs"]),
                                port["pairs"], CFG["k_bits"], CFG["n_tables"])
    assert float(cp) == case["cp"] and float(cn) == case["cn"]


def test_adamw_update_matches():
    """One AdamW step (with weight decay) on a nested dict, from JAX's
    moments after two steps, so that the bias correction is at t = 3."""
    rng = np.random.default_rng(5)
    params = {"a": rng.normal(size=(17, 6)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p, i=i: (p * (i + 1) - 0.3).astype(
        np.float32), params) for i in range(3)]
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.adamw_init(jp)
    upd = jax.jit(functools.partial(jadamw.adamw_update, lr=0.05,
                                    weight_decay=0.01))
    for g in grads[:2]:
        jp, js = upd(g, js, jp)
    tp = jax.tree.map(lambda a: _t(a), jp)
    ts = adamw_state_from_numpy(js.step, jax.tree.map(np.array, js.mu),
                                jax.tree.map(np.array, js.nu), device="cpu")
    jp, js = upd(grads[2], js, jp)
    tg = jax.tree.map(_t, grads[2])
    tp, ts = adamw_update(tg, ts, tp, lr=0.05, weight_decay=0.01)
    assert int(ts.step) == int(js.step) == 3
    for path in (("a",), ("b", "c")):
        get = lambda tree: functools.reduce(lambda t, k: t[k], path, tree)
        for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            assert_close(get(got), get(want), rtol=1e-6, atol=1e-6,
                         what="/".join(path))
    # a bare tensor is a tree too
    p1, s1 = adamw_update(torch.ones(3), adamw_init(torch.zeros(3)),
                          torch.zeros(3), lr=0.1)
    assert torch.allclose(p1, torch.full((3,), -0.1)) and int(s1.step) == 1


def test_clip_by_global_norm_matches():
    rng = np.random.default_rng(6)
    g = {"a": rng.normal(size=(4, 3)).astype(np.float32),
         "b": rng.normal(size=(7,)).astype(np.float32)}
    jg, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.5)
    tg, tn = clip_by_global_norm({k: _t(v) for k, v in g.items()}, 1.5)
    assert_close(tn, jn, rtol=1e-6, atol=1e-6, what="norm")
    for k in g:
        assert_close(tg[k], jg[k], rtol=1e-6, atol=1e-6, what=k)


def test_iul_train_epoch_matches_with_jax_order(case, port):
    """One epoch of 4 mined batches x 4 Adam steps, fed JAX's batch order
    (``split`` the key, then ``permutation``), from JAX's thresholds."""
    cfg = jlss.LSSConfig(**CFG)
    _, ke = jax.random.split(jax.random.PRNGKey(3))
    n_batches = N // CFG["iul_batch"]
    order = np.array(jax.random.permutation(ke, N))[
        : n_batches * CFG["iul_batch"]].reshape(n_batches, -1)
    theta = jnp.asarray(case["theta"])
    index = jlss.build_index(jnp.asarray(case["w_aug"]), theta, cfg)
    j_theta, j_opt, (j_loss, j_cp, j_cn) = jax.jit(
        jiul.iul_train_epoch, static_argnames=("cfg",))(
        theta, jadamw.adamw_init(theta), jnp.asarray(case["q_aug"]),
        jnp.asarray(case["labels"]), jnp.asarray(case["w_aug"]), index,
        jnp.float32(case["t1"]), jnp.float32(case["t2"]), cfg, ke)
    t_theta, t_opt, (t_loss, t_cp, t_cn) = iul.iul_train_epoch(
        port["theta"], adamw_init(port["theta"]), port["q_aug"],
        port["labels"], port["w_aug"], port["index"],
        torch.tensor(case["t1"]), torch.tensor(case["t2"]), port["cfg"],
        torch.from_numpy(order))
    assert t_loss.shape == (n_batches,)
    assert_close(t_loss, j_loss, rtol=1e-5, atol=1e-5, what="losses")
    assert_close(t_theta, j_theta, rtol=1e-4, atol=1e-4, what="theta")
    assert int(t_opt.step) == int(j_opt.step) == n_batches * 4
    assert_close(t_cp, j_cp, rtol=0, atol=1e-6, what="p_collide_pos")
    assert_close(t_cn, j_cn, rtol=0, atol=1e-6, what="p_collide_neg")


def test_iul_refit_epoch_matches(case):
    """One refit epoch from ``iul_init`` with JAX's θ.  All N rows form one
    batch (``iul_batch = N``), so the batch order, which the port draws
    from its own generator, changes only the order of the loss's sums."""
    cfg_kw = dict(CFG, iul_batch=N)
    jcfg, tcfg = jlss.LSSConfig(**cfg_kw), LSSConfig(**cfg_kw)
    q_aug, w_aug = jnp.asarray(case["q_aug"]), jnp.asarray(case["w_aug"])
    lab = jnp.asarray(case["labels"])
    jstate = jiul.iul_init(jax.random.PRNGKey(4), q_aug, lab, w_aug, jcfg,
                           theta=jnp.asarray(case["theta"]))
    index = jlss.build_index(w_aug, jstate.theta, jcfg)
    jstate, jindex, jinfo = jiul.iul_refit_epoch(jstate, q_aug, lab, w_aug,
                                                 index, jcfg)
    tstate = iul.iul_init(torch.Generator().manual_seed(0),
                          _t(case["q_aug"]), _t(case["labels"]),
                          _t(case["w_aug"]), tcfg, theta=_t(case["theta"]))
    assert abs(float(tstate.t1) - case["t1"]) <= 1e-6
    tstate, tindex, tinfo = iul.iul_refit_epoch(
        tstate, _t(case["q_aug"]), _t(case["labels"]), _t(case["w_aug"]),
        lss_index_from_numpy(**_index_np(index), device="cpu"), tcfg)
    assert_close(tstate.theta, jstate.theta, rtol=1e-4, atol=1e-4,
                 what="theta")
    assert tinfo.keys() == jinfo.keys()
    assert tinfo["loss"] == pytest.approx(jinfo["loss"], rel=1e-5, abs=1e-5)
    # the rebuilt tables: equal on every bucket that no neuron near a
    # hyperplane (margin <= 1e-5 under either θ) can move into or out of
    tt, jt = tindex.tables, jindex.tables
    assert (tt.k_bits, tt.n_tables, tt.capacity) == \
        (jt.k_bits, jt.n_tables, jt.capacity)
    w_np = case["w_aug"]
    near = (hash_margin(w_np, np.array(jstate.theta)) <= 1e-5) | \
        (hash_margin(w_np, tstate.theta) <= 1e-5)
    keep = np.ones(np.array(jt.table_ids).shape[:2], bool)
    for theta in (np.array(jstate.theta), tstate.theta.numpy()):
        b = np.array(jsim.bucket_ids(jnp.asarray(w_np[near]),
                                     jnp.asarray(theta), tt.k_bits,
                                     tt.n_tables))
        for t in range(tt.n_tables):
            keep[t, b[:, t]] = False
    assert keep.mean() > 0.5
    assert_ints_equal(tt.table_ids.numpy()[keep],
                      np.array(jt.table_ids)[keep], what="rebuilt tables")
    if not near.any():
        assert tinfo["recall"] == pytest.approx(jinfo["recall"], abs=1e-7)
        assert tinfo["p_collide_pos"] == pytest.approx(
            jinfo["p_collide_pos"], abs=1e-6)
        assert tinfo["p_collide_neg"] == pytest.approx(
            jinfo["p_collide_neg"], abs=1e-6)


# ------------------------------ the JAX package's tests, on the port --

def test_mine_pairs_matches_naive():
    rng = np.random.default_rng(0)
    m, d, n = 100, 8, 16
    w = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(-1, m, size=(n, 3))
                              .astype(np.int32))
    cfg = LSSConfig(k_bits=3, n_tables=2)
    w_aug = simhash.augment_neurons(w, None)
    q_aug = simhash.augment_queries(q)
    theta = simhash.init_hyperplanes(torch.Generator().manual_seed(3),
                                     d + 1, 3, 2, device="cpu")
    index = build_index(w_aug, theta, cfg)
    pairs = iul.mine_pairs(q_aug, labels, w_aug, index, torch.tensor(0.5),
                           torch.tensor(-0.5))

    cand, _ = retrieve(q_aug, index)
    candn, labn = cand.numpy(), labels.numpy()
    ip = (q_aug @ w_aug.T).numpy()
    pos, neg = pairs.pos_mask.numpy(), pairs.neg_mask.numpy()
    for i in range(n):
        s = set(x for x in candn[i] if x >= 0)
        for j, y in enumerate(labn[i]):
            want = y >= 0 and y not in s and ip[i, y] > 0.5
            assert bool(pos[i, j]) == want, (i, j)
        labset = set(x for x in labn[i] if x >= 0)
        for c_idx, cid in enumerate(candn[i]):
            want = cid >= 0 and cid not in labset and ip[i, cid] < -0.5
            assert bool(neg[i, c_idx]) == want, (i, c_idx)


def test_iul_loss_decreases_and_separates():
    """150 steps on one pair batch must raise positive collisions and
    suppress negative ones (the single-batch convergence experiment)."""
    rng = np.random.default_rng(0)
    d, m, n = 32, 500, 128
    w = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, m, size=n))
    q = 0.9 * w[y] + 0.4 * torch.from_numpy(
        rng.normal(size=(n, d)).astype(np.float32))
    labels = y[:, None].to(torch.int32)
    cfg = LSSConfig(k_bits=4, n_tables=1)
    w_aug = simhash.augment_neurons(w, None)
    q_aug = simhash.augment_queries(q)
    theta = simhash.init_hyperplanes(torch.Generator().manual_seed(3),
                                     d + 1, 4, 1, device="cpu")
    index = build_index(w_aug, theta, cfg)
    t1, t2 = iul.calibrate_thresholds(q_aug, w_aug, labels, cfg)
    pairs = iul.mine_pairs(q_aug, labels, w_aug, index, t1, t2)
    opt = adamw_init(theta)
    rows = _pair_rows(w_aug, pairs)
    cp0, cn0 = iul.collision_prob(theta, q_aug, *rows, pairs, 4, 1)
    l0 = None
    for _ in range(150):
        loss, g = iul.iul_loss_and_grad(theta, q_aug, w_aug, pairs)
        if l0 is None:
            l0 = float(loss)
        theta, opt = adamw_update(g, opt, theta, lr=0.02)
    cp1, cn1 = iul.collision_prob(theta, q_aug, *rows, pairs, 4, 1)
    assert float(loss) < l0 * 0.8
    assert float(cp1) > float(cp0) + 0.2         # positives pulled in
    assert float(cn1) < float(cn0) - 0.2         # negatives pushed out


def test_fit_lss_beats_random_hash_on_structured_data():
    """Paper §4.2: the learned index must retrieve labels better than
    random SimHash at the same sample size (topic-structured data).  Runs
    under no_grad, as a serving process would call it."""
    rng = np.random.default_rng(0)
    d, m, n, n_topics = 32, 1000, 768, 24
    cent = rng.normal(size=(n_topics, d))
    topic = rng.integers(0, n_topics, size=m)
    w = cent[topic] + 0.45 * rng.normal(size=(m, d))
    y = rng.integers(0, m, size=n)
    q = cent[topic[y]] + 0.3 * rng.normal(size=(n, d)) + 0.3 * w[y]
    w = torch.from_numpy(w.astype(np.float32))
    q = torch.from_numpy(q.astype(np.float32))
    labels = torch.from_numpy(y[:, None].astype(np.int32))
    cfg = LSSConfig(k_bits=4, n_tables=1, iul_epochs=8, iul_batch=256,
                    iul_lr=0.02, iul_inner_steps=10)
    q_aug = simhash.augment_queries(q)
    # random-hash baseline (SLIDE)
    theta0 = simhash.init_hyperplanes(torch.Generator().manual_seed(9),
                                      d + 1, 4, 1, device="cpu")
    idx0 = build_index(simhash.augment_neurons(w, None), theta0, cfg)
    rec0 = float(label_recall(retrieve(q_aug, idx0)[0], labels))
    with torch.no_grad():
        index, hist = iul.fit_lss(torch.Generator().manual_seed(1), q,
                                  labels, w, None, cfg)
    rec1 = float(label_recall(retrieve(q_aug, index)[0], labels))
    assert rec1 > rec0 + 0.05, (rec0, rec1, hist["recall"])
    # best-epoch selection: the index served is the best epoch's, and its
    # tables are its own θ's
    assert len(hist["loss"]) == cfg.iul_epochs
    assert all(np.isfinite(hist["loss"]))
    assert iul.calib_recall(index, q_aug, labels) == max(hist["recall"])
    own = build_index(simhash.augment_neurons(w, None), index.theta, cfg)
    assert torch.equal(own.tables.table_ids, index.tables.table_ids)
