"""The trainer, checkpoints, schedules and batch pipeline of the port: the
JAX package's ``test_train_infra.py`` on the port alone (CPU), and parity
with the JAX package on the same numpy inputs.

Tolerances:
* schedules: rtol 1e-6 (fp32 ``cos`` of the two libraries may differ in
  the last bit);
* batches, checkpoint leaves (bf16 ones bit for bit), blockwise int8
  quantization against the JAX package's: exact;
* one train step: loss, gradient norm and lr rtol 1e-5; gradients rtol
  1e-5 and atol 1e-8 (the sums run in other orders), zero in the same
  elements, and elsewhere within 1% of their own size; parameters after
  the Adam step atol 1e-6.  Adam's step-1 update is ``g / (|g| + 1e-8)``,
  ~``lr * sign(g)``: a gradient element whose two values differed in sign
  would move its parameter by 2 lr (1e-2), which the 1% check rules out.
  Otherwise the update's slope in g is ``1e-8 / (|g| + 1e-8)**2``: the
  tiny XC model's smallest clipped gradient element (~4e-8) and the
  measured gradient differences (~1e-10) move an update by ~2e-4, a
  parameter by ~1e-6 at lr 5e-3;
* a JAX run resumed in the port: atol 1e-6 after 20 Adam steps in the
  port, each of which adds the last bits of both frameworks' gradients
  (1.0e-7 measured on the CPU).
"""

import gc
import json
import os
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import ShardedBatchIterator as JIterator  # noqa: E402
from repro.models import xc as jxc  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.optim import compression as jcompression  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.data.pipeline import ShardedBatchIterator  # noqa: E402
from repro_torch.data.synthetic import xc_dataset  # noqa: E402
from repro_torch.models import xc  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.optim.compression import (dequantize_int8,  # noqa: E402
                                           quantize_int8)
from repro_torch.testing.parity import assert_close  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.trainer import (TrainConfig, Trainer,  # noqa: E402
                                       init_state, make_train_step,
                                       value_and_grad)
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

XC_CFG = dict(input_dim=500, hidden=16, output_dim=300, max_in=12,
              max_labels=4)


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


def _quad_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def _jquad_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean((pred - batch["y"]) ** 2)


def _init_fn(generator):
    return {"w": torch.randn((8, 1), generator=generator) * 0.1,
            "b": torch.zeros((1,))}


def _data(n=256):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    w = rng.normal(size=(8, 1)).astype(np.float32)
    y = x @ w + 0.01 * rng.normal(size=(n, 1)).astype(np.float32)
    return {"x": x, "y": y}


def _xc_data(n=128):
    d = xc_dataset(5, n, XC_CFG["input_dim"], XC_CFG["output_dim"],
                   n_topics=8, max_in=XC_CFG["max_in"],
                   max_labels=XC_CFG["max_labels"])
    return {"x": d.x, "labels": d.labels}


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(jstate):
    """The port's TrainState holding a JAX TrainState's values."""
    s = _np_tree(jstate)
    return train_state_from_numpy(s.params, tuple(s.opt), s.step,
                                  device="cpu")


def _port_names(params):
    return {("embed_table" if k == "embed" else k): v
            for k, v in params.items()}


def _assert_state_equal(port_state, jstate):
    """Leaf for leaf, exactly; the two trees flatten in the same order."""
    got = [np.asarray(t) for t in tree_leaves(port_state)]
    want = [np.asarray(a) for a in jax.tree.leaves(jstate)]
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------- the JAX tests, on the port

def test_loss_decreases():
    tc = TrainConfig(lr=0.05, warmup_steps=5, total_steps=100,
                     ckpt_every=1000)
    tr = Trainer(_quad_loss, _init_fn, tc, device="cpu")
    it = ShardedBatchIterator(_data(), 32, seed=0, device="cpu")
    state, hist = tr.fit(_gen(), it, 60, log_every=20)
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.2
    assert [h["step"] for h in hist] == [20, 40, 60]


def test_microbatch_equals_fullbatch_grads():
    tc1 = TrainConfig(lr=0.1, warmup_steps=0, clip_norm=1e9, microbatches=1)
    tc4 = tc1._replace(microbatches=4)
    s1 = init_state(_gen(), _init_fn, tc1)
    s4 = init_state(_gen(), _init_fn, tc4)
    batch = {k: torch.from_numpy(v[:64]) for k, v in _data().items()}
    n1, _ = make_train_step(_quad_loss, tc1)(s1, batch)
    n4, _ = make_train_step(_quad_loss, tc4)(s4, batch)
    np.testing.assert_allclose(n1.params["w"].numpy(), n4.params["w"].numpy(),
                               rtol=1e-5)


def test_step_frees_the_old_state_without_the_collector():
    """A step makes no reference cycle: the state it replaces is freed as
    soon as the caller drops it (a cycle kept every step's parameters and
    moments alive until the collector ran: 2.4 GB a step at Delicious-200K
    width on the card)."""
    tcfg = xc.XCConfig("tiny", **XC_CFG)
    tc = TrainConfig(lr=5e-3, warmup_steps=0)
    step = make_train_step(lambda p, b: xc.loss(p, b, tcfg), tc)
    state = init_state(_gen(), lambda g: xc.init_params(g, tcfg, "cpu"), tc)
    batch = {k: torch.from_numpy(v[:32]) for k, v in _xc_data().items()}
    gc.collect()
    gc.disable()
    try:
        refs = [weakref.ref(t) for t in tree_leaves(state)]
        state, _ = step(state, batch)
        assert all(r() is None for r in refs)
        assert gc.collect() == 0
    finally:
        gc.enable()


def test_checkpoint_roundtrip_and_retention(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"a": torch.arange(5.0), "b": {"c": torch.ones((2, 2))}}
    for step in (10, 20, 30, 40):
        ckpt.save(d, step, tree, extra={"data": {"step": step}}, keep_last=2)
    assert ckpt.all_steps(d) == [30, 40]
    assert ckpt.latest_step(d) == 40
    like = tree_map(torch.zeros_like, tree)
    got, extra = ckpt.restore(d, 40, like)
    np.testing.assert_allclose(got["a"].numpy(), np.arange(5.0))
    np.testing.assert_allclose(got["b"]["c"].numpy(), np.ones((2, 2)))
    assert extra["data"]["step"] == 40


def test_torn_checkpoint_skipped(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"a": torch.arange(3.0)}
    ckpt.save(d, 1, tree)
    ckpt.save(d, 2, tree)
    os.remove(os.path.join(d, "step_2", "leaves.npz"))      # corrupt newest
    got = ckpt.restore_latest(d, tree)
    assert got is not None and got[2] == 1
    # a directory still being written (tmp.<n>) is never a checkpoint
    os.makedirs(os.path.join(d, "tmp.3"))
    assert ckpt.all_steps(d) == [1, 2]


def test_bf16_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    x = torch.randn(7, 3, generator=_gen(5)).to(torch.bfloat16)
    tree = {"w": x, "s": torch.arange(4.0)}
    ckpt.save(d, 3, tree)
    stored = np.load(os.path.join(d, "step_3", "leaves.npz"))["leaf_00001"]
    assert stored.dtype == np.dtype("V2")            # JAX's layout
    got, _ = ckpt.restore(d, 3, tree_map(torch.zeros_like, tree))
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), x.view(torch.int16))
    assert torch.equal(got["s"], tree["s"])
    # a float32 ``like`` takes the bf16 values, widened
    wide, _ = ckpt.restore(d, 3, {"w": torch.zeros(7, 3),
                                  "s": torch.zeros(4)})
    assert wide["w"].dtype == torch.float32
    assert torch.equal(wide["w"], x.float())


def test_bf16_checkpoint_from_jax_restores_in_port(tmp_path):
    d = str(tmp_path / "ck")
    x = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    jtree = {"a": jnp.asarray(x).astype(jnp.bfloat16),
             "b": {"c": jnp.arange(3.0)}}
    jckpt.save(d, 9, jtree, extra={"data": {"step": 9, "seed": 1}})
    like = {"a": torch.zeros(5, 4, dtype=torch.bfloat16),
            "b": {"c": torch.zeros(3)}}
    got, extra, step = ckpt.restore_latest(d, like)
    assert step == 9 and extra == {"data": {"step": 9, "seed": 1}}
    want = np.asarray(jtree["a"]).view(np.int16)
    np.testing.assert_array_equal(got["a"].view(torch.int16).numpy(), want)
    np.testing.assert_array_equal(got["b"]["c"].numpy(), np.arange(3.0))
    # saved again by the port: the same stored leaves and manifest dtypes
    # as the JAX package wrote
    ckpt.save(str(tmp_path / "port"), 9, got)
    manifests, leaves = [], []
    for root in (d, str(tmp_path / "port")):
        with open(os.path.join(root, "step_9", "manifest.json")) as f:
            manifests.append(json.load(f)["dtypes"])
        with np.load(os.path.join(root, "step_9", "leaves.npz")) as z:
            leaves.append({k: z[k] for k in z.files})
    assert manifests[0] == manifests[1]
    assert manifests[1]["leaf_00000"] == "bfloat16"
    for k, v in leaves[0].items():
        assert leaves[1][k].dtype == v.dtype
        assert leaves[1][k].tobytes() == v.tobytes()


def test_int8_quant_error_bound():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1000,)).astype(np.float32)) * 3
    q, s = quantize_int8(x)
    back = dequantize_int8(q, s, x.shape, torch.float32)
    err = (back - x).abs().numpy()
    # blockwise symmetric int8: |err| <= scale/2 per block
    bound = np.repeat(s.numpy(), 256)[:1000] * 0.5 + 1e-6
    assert (err <= bound).all()


@pytest.mark.parametrize("shape", [(1000,), (3, 7, 29), (256,)])
def test_int8_blockwise_matches_jax(shape):
    """Exact: the same fp32 max, divide and round-half-even."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=shape) * 2).astype(np.float32)
    x.reshape(-1)[:256] = 0.0                   # an all-zero block
    jq, js = jcompression.quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and tuple(q.shape) == jq.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = dequantize_int8(q, s, shape, torch.bfloat16)
    jback = jcompression.dequantize_int8(jq, js, shape, jnp.bfloat16)
    assert back.shape == shape and back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.view(torch.int16).numpy(),
                                  np.asarray(jback).view(np.int16))


def test_preemption_resume_identical(tmp_path):
    """Crash at step 25, resume -> the same final params as uninterrupted."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    tc = TrainConfig(lr=0.05, warmup_steps=0, total_steps=50, ckpt_every=10)
    data = _data()

    tr_ref = Trainer(_quad_loss, _init_fn, tc, ckpt_dir=d1, device="cpu")
    it = ShardedBatchIterator(data, 32, seed=7, device="cpu")
    ref_state, _ = tr_ref.fit(_gen(), it, 40, log_every=100)

    tr1 = Trainer(_quad_loss, _init_fn, tc, ckpt_dir=d2, device="cpu")
    it2 = ShardedBatchIterator(data, 32, seed=7, device="cpu")
    with pytest.raises(RuntimeError, match="simulated preemption"):
        tr1.fit(_gen(), it2, 40, crash_after=25, log_every=100)
    tr2 = Trainer(_quad_loss, _init_fn, tc, ckpt_dir=d2, device="cpu")
    it3 = ShardedBatchIterator(data, 32, seed=7, device="cpu")
    got_state, _ = tr2.fit(_gen(), it3, 40, log_every=100)
    assert it3.step == 40 and int(got_state.step) == 40
    np.testing.assert_allclose(got_state.params["w"].numpy(),
                               ref_state.params["w"].numpy(), rtol=1e-6)


def test_pipeline_resume_determinism():
    data = _data(128)
    it1 = ShardedBatchIterator(data, 32, seed=3, device="cpu")
    batches = [next(it1) for _ in range(7)]
    state = it1.state_dict()
    # a fresh iterator resumed at step 5 reproduces batches 5..
    it2 = ShardedBatchIterator(data, 32, seed=3, start_step=5, device="cpu")
    for i in range(5, 7):
        assert torch.equal(next(it2)["x"], batches[i]["x"])
    assert state["step"] == 7
    it3 = ShardedBatchIterator(data, 32, seed=0, device="cpu")
    it3.load_state_dict(state)
    assert it3.state_dict() == state


# --------------------------------------------------- parity with the JAX package

@pytest.mark.parametrize("make", [
    lambda m: m.constant_schedule(3e-4),
    lambda m: m.cosine_schedule(5e-3, 100),
    lambda m: m.linear_warmup_cosine(5e-3, 30, 500),
    lambda m: m.linear_warmup_cosine(0.05, 0, 50),
], ids=["constant", "cosine", "warmup_cosine", "no_warmup"])
def test_schedules_match_jax(make):
    jfn, tfn = make(jsched), make(schedules)
    total = 500
    want = np.array(jax.jit(jax.vmap(lambda s: jnp.broadcast_to(
        jfn(s), ())))(jnp.arange(total + 1, dtype=jnp.int32)))
    got = np.array([tfn(torch.tensor(s, dtype=torch.int32)).numpy()
                    for s in range(total + 1)])
    one = tfn(torch.tensor(7, dtype=torch.int32))
    assert one.dtype == torch.float32 and one.shape == ()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_batches_equal_jax_over_two_epochs():
    data = _xc_data(100)
    jit_ = JIterator(data, 32, seed=4)
    it = ShardedBatchIterator(data, 32, seed=4, device="cpu")
    assert it.batches_per_epoch == jit_.batches_per_epoch == 3
    for _ in range(2 * it.batches_per_epoch):
        want, got = next(jit_), next(it)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.from_numpy(want[k]).dtype
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert it.state_dict() == jit_.state_dict()


def _step_case(kind, microbatches):
    """(JAX loss, port loss, JAX init state, batch as numpy, TrainConfig
    kwargs)."""
    kw = dict(lr=5e-3, warmup_steps=0, total_steps=10, weight_decay=0.01,
              microbatches=microbatches)
    if kind == "quad":
        params = {"w": np.random.default_rng(1).normal(size=(8, 1)).astype(
            np.float32) * 0.1, "b": np.zeros((1,), np.float32)}
        batch = {k: v[:64] for k, v in _data().items()}
        return (_jquad_loss, _quad_loss, params, batch,
                dict(kw, clip_norm=1e9))
    cfg = jxc.XCConfig("tiny", **XC_CFG)
    tcfg = xc.XCConfig("tiny", **XC_CFG)
    params = _np_tree(jxc.init_params(jax.random.PRNGKey(0), cfg))
    batch = {k: v[:64] for k, v in _xc_data().items()}
    # a clip norm below the gradient's, so the clipping path is taken
    return (lambda p, b: jxc.loss(p, b, cfg),
            lambda p, b: xc.loss(p, b, tcfg), params, batch,
            dict(kw, clip_norm=0.05))


@pytest.mark.parametrize("kind,microbatches", [
    ("quad", 1), ("quad", 4), ("xc", 1), ("xc", 2)])
def test_train_step_matches_jax(kind, microbatches):
    jloss, tloss, params, batch, kw = _step_case(kind, microbatches)
    jtc, tc = jtrainer.TrainConfig(**kw), TrainConfig(**kw)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0),
                                 lambda k: jax.tree.map(jnp.asarray, params),
                                 jtc)
    state = _port_state(jstate)
    jbatch = jax.tree.map(jnp.asarray, batch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    # the gradient, tightly
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jstate.params, jbatch)
    tl, tg = value_and_grad(tloss, state.params, tbatch)
    jg = _port_names(_np_tree(jg))
    for k in jg:
        assert_close(tg[k], jg[k], rtol=1e-5, atol=1e-8, what=f"grad {k}")
        g, want = tg[k].numpy(), jg[k]
        np.testing.assert_array_equal(g == 0, want == 0)
        nz = want != 0
        assert (np.abs(g - want)[nz] < 1e-2 * np.abs(want)[nz]).all(), k

    jnew, jm = jax.jit(jtrainer.make_train_step(jloss, jtc))(jstate, jbatch)
    with torch.no_grad():                 # the step enables grad itself
        new, m = make_train_step(tloss, tc)(state, tbatch)
    for k in ("loss", "grad_norm", "lr"):
        assert_close(m[k], jm[k], rtol=1e-5, atol=0, what=k)
    if kind == "xc":
        assert float(m["grad_norm"]) > kw["clip_norm"]
    assert int(new.step) == 1 and int(new.opt.step) == 1
    jp = _port_names(_np_tree(jnew.params))
    for k in jp:
        assert_close(new.params[k], jp[k], rtol=0, atol=1e-6,
                     what=f"param {k}")
    # the step is functional: its argument is unchanged
    np.testing.assert_array_equal(state.params[next(iter(jp))].numpy(),
                                  _port_names(params)[next(iter(jp))])


@pytest.fixture(scope="module")
def xc_states():
    """A JAX TrainState of the tiny XC model after one step (nonzero Adam
    moments), and the port's copy of it."""
    cfg = jxc.XCConfig("tiny", **XC_CFG)
    jtc = jtrainer.TrainConfig(lr=5e-3, warmup_steps=0)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0),
                                 lambda k: jxc.init_params(k, cfg), jtc)
    batch = jax.tree.map(jnp.asarray, {k: v[:64]
                                       for k, v in _xc_data().items()})
    jstate, _ = jax.jit(jtrainer.make_train_step(
        lambda p, b: jxc.loss(p, b, cfg), jtc))(jstate, batch)
    return jstate, _port_state(jstate)


def test_checkpoint_from_jax_restores_in_port(tmp_path, xc_states):
    jstate, _ = xc_states
    d = str(tmp_path / "ck")
    jckpt.save(d, 7, jstate, extra={"data": {"step": 7, "seed": 0}})
    tcfg = xc.XCConfig("tiny", **XC_CFG)
    like = init_state(_gen(), lambda g: xc.init_params(g, tcfg, "cpu"),
                      TrainConfig())
    got, extra, step = ckpt.restore_latest(d, like)
    assert step == 7 and extra == {"data": {"step": 7, "seed": 0}}
    assert set(got.params) == {"embed_table", "w_out", "b_out"}
    _assert_state_equal(got, jstate)


def test_checkpoint_from_port_restores_in_jax(tmp_path, xc_states):
    jstate, state = xc_states
    d = str(tmp_path / "ck")
    ckpt.save(d, 7, state, extra={"data": {"step": 7, "seed": 0}})
    like = jax.tree.map(jnp.zeros_like, jstate)
    got, extra = jckpt.restore(d, 7, like)
    assert extra == {"data": {"step": 7, "seed": 0}}
    _assert_state_equal(state, got)
    _assert_state_equal(state, jstate)


def test_jax_run_resumes_in_port(tmp_path):
    """A JAX Trainer crashes at step 25 (checkpoints every 10); the port's
    Trainer resumes from JAX's step 20 and ends where the uninterrupted JAX
    run ends."""
    cfg = jxc.XCConfig("tiny", **XC_CFG)
    tcfg = xc.XCConfig("tiny", **XC_CFG)
    kw = dict(lr=5e-3, warmup_steps=5, total_steps=40, weight_decay=0.0,
              ckpt_every=10)
    data = _xc_data()
    jargs = (lambda p, b: jxc.loss(p, b, cfg),
             lambda k: jxc.init_params(k, cfg), jtrainer.TrainConfig(**kw))

    jref, _ = jtrainer.Trainer(*jargs, ckpt_dir=str(tmp_path / "a")).fit(
        jax.random.PRNGKey(0), JIterator(data, 32, seed=7), 40,
        log_every=100)
    d = str(tmp_path / "b")
    with pytest.raises(RuntimeError, match="simulated preemption"):
        jtrainer.Trainer(*jargs, ckpt_dir=d).fit(
            jax.random.PRNGKey(0), JIterator(data, 32, seed=7), 40,
            crash_after=25, log_every=100)
    assert jckpt.all_steps(d) == [10, 20]

    tr = Trainer(lambda p, b: xc.loss(p, b, tcfg),
                 lambda g: xc.init_params(g, tcfg, "cpu"), TrainConfig(**kw),
                 ckpt_dir=d, device="cpu")
    it = ShardedBatchIterator(data, 32, seed=7, device="cpu")
    state, hist = tr.fit(_gen(), it, 40, log_every=10)
    assert [h["step"] for h in hist] == [30, 40] and it.step == 40
    want = _port_names(_np_tree(jref.params))
    for k in want:
        assert_close(state.params[k], want[k], rtol=0, atol=1e-6,
                     what=f"param {k}")


def test_entry_points_refuse_without_gpu(monkeypatch):
    from repro_torch.examples import quickstart, train_wol
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_quad_loss, _init_fn, TrainConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedBatchIterator(_data(), 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_wol.run(fast=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main([])


def test_train_wol_runs_and_resumes_on_cpu(tmp_path):
    """The example's run at the bench width: its stages, its checkpoints,
    and a trainer that resumes from the final one."""
    from repro_torch.examples import train_wol
    stages = []
    res = train_wol.run(fast=True, steps=20, ckpt_dir=str(tmp_path),
                        device="cpu", on_stage=stages.append)
    assert stages == ["train", "fit_lss", "serve"]
    assert [h["step"] for h in res["history"]] == [20]
    assert len(res["iul_history"]["recall"]) == res["lss_config"].iul_epochs
    assert res["n_test"] == 512 and res["n_dropped"] >= 0
    for head in ("full", "lss"):
        assert 0.0 <= res[head]["P@1"] <= 1.0
    assert ckpt.all_steps(str(tmp_path)) == [20]
    tr = res["trainer"]
    assert len(tr.save_seconds) == 1          # the final save only
    resumed = tr.init_or_resume(_gen(1))
    for got, want in zip(tree_leaves(resumed), tree_leaves(res["state"])):
        assert torch.equal(got, want)
