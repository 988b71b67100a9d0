"""Sharded training on the CPU (counterpart of the JAX package's
``tests/test_multidevice.py`` parts 2 and 3, and of the mesh cases of
``tests/test_train_infra.py``): real ``torch.distributed`` fleets over
gloo, each rank with one intra-op thread and a timeout on every wait.

* One train step on a (data, model) mesh equals the port's one-device
  step and the JAX package's one-device ``Trainer`` step from the same
  numpy parameters: the reduced qwen2-0.5b (vocab 512) on (1, 2) and
  (2, 2), the XC model (500 -> 16 -> 300) on (1, 2), (2, 1) and (2, 2),
  the LSTM on (1, 2).  Loss, grad norm and lr to rtol 1e-5; parameters
  to atol 1e-6 after the step.  Adam's first update is ``g / (|g| +
  1e-8)``, whose slope in g is ``1e-8 / (|g| + 1e-8)**2``: a gradient
  element near 1e-8, whose fp32 sums in another order move it by tens of
  percent (or flip its sign: the reduced transformer has such elements,
  ~1e-7 of noise on gradients up to 0.4), moves its parameter by up to
  2 lr.  So the XC and LSTM steps (PR 15's and the reference's settings;
  XC's clip norm below its gradient's, so the sharded clip is taken)
  hold every parameter to 1e-6, and the transformer steps (lr 1e-4, no
  clip: the clip scales every element towards 1e-8) hold their Adam
  first moment ``mu = 0.1 g`` to 1e-7 everywhere, and the parameters to
  1e-6 wherever |g| >= 1e-6 (a slope below 1e4: 1e-7 of noise moves the
  update by 1e-3, the parameter by 1e-7) and to Adam's bound of 2 lr
  elsewhere.
* The collectives of one (1, 2) step (``CommDebugMode``, with shapes):
  no all-gather whose output is a model-sharded parameter or the
  logits, whole; the XC step's collectives counted one by one; a
  transformer whose heads the model axis divides gathers nothing.
* ``compressed_psum`` on 4 ranks: within 5e-3 of the fp32 mean, a
  non-zero error state, and JAX's ``compressed_psum`` (a subprocess
  with 4 host devices, as ``tests/test_multidevice.py`` runs it) on the
  same rows.
* ``param_specs``/``cache_specs`` equal JAX's; ``specs_to_shardings``
  drops an axis the mesh lacks.
* The (2, 1) iterator gives each rank the rows JAX's iterator gives
  that data shard; the global batch is one device's.
* A checkpoint saved on (1, 2) resumes on (2, 1) and on one device to
  the uninterrupted run (atol 1e-6), and JAX's ``checkpoint.restore``
  reads it leaf for leaf.
* ``launch.train --devices 2 --mesh 1x2`` trains; a rerun on 2x1
  resumes.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs.reduced import reduced_model_cfg as j_reduced  # noqa: E402
from repro.models import lstm as jlstm  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models import xc as jxc  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.configs.reduced import reduced_model_cfg  # noqa: E402
from repro_torch.data.pipeline import ShardedBatchIterator  # noqa: E402
from repro_torch.data.synthetic import lm_dataset, xc_dataset  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import lstm, xc  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.testing.parity import assert_close  # noqa: E402
from repro_torch.train.trainer import (TrainConfig, Trainer,  # noqa: E402
                                       init_state, make_train_step)
from repro_torch.utils.sharding import P, specs_to_shardings  # noqa: E402
from repro_torch.utils.tree import tree_flatten, tree_map  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TIMEOUT_S = 240
# the transformer's sequence: with batch 16 and d_model 64 no activation
# has the element count of a parameter or of the logits, so a gather's
# size names what it gathered
SEQ = 24

XC_CFG = dict(input_dim=500, hidden=16, output_dim=300, max_in=12,
              max_labels=4)
LSTM_CFG = dict(vocab=64, hidden=16, n_layers=2)
# (config, TrainConfig kwargs, batch size, iterator seed) a model
CASES = {
    "xc": dict(tc=dict(lr=5e-3, warmup_steps=0, total_steps=10,
                       weight_decay=0.01, clip_norm=0.05), batch=64, seed=4),
    "lstm": dict(tc=dict(lr=1e-3, warmup_steps=0, total_steps=8),
                 batch=16, seed=0),
    "lm": dict(n_kv_heads=1, tc=dict(lr=1e-4, warmup_steps=0,
                                     total_steps=8, clip_norm=1e9),
               batch=16, seed=0),
    "lm_kv2": dict(n_kv_heads=2, tc=dict(lr=1e-4, warmup_steps=0,
                                         total_steps=8, clip_norm=1e9),
                   batch=16, seed=0),
}
STRICT = {"xc", "lstm"}      # every parameter to 1e-6 (see above)
# the checkpoint case: XC at the reference's lr, its gradient norm (~0.12)
# below the clip norm
CKPT_TC = dict(lr=1e-3, warmup_steps=0, total_steps=10, weight_decay=0.01,
               ckpt_every=10 ** 9)
CKPT_STEPS, RESUME_STEPS = 2, 4

_WORKER = r"""
import json, os, shutil, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.configs.reduced import reduced_model_cfg
from repro_torch.convert import sharded_train_state_from_numpy
from repro_torch.data.pipeline import ShardedBatchIterator
from repro_torch.distributed import init_distributed, shutdown_distributed
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import lstm, transformer as T, xc
from repro_torch.optim.compression import compressed_psum, init_error_state
from repro_torch.train.trainer import TrainConfig, Trainer, make_train_step
from repro_torch.utils.sharding import CollectiveLog, full_tensor, use_mesh
from repro_torch.utils.tree import tree_map

d, rank, world, tag = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    sys.argv[4]
tasks = sys.argv[5].split(",")
shape = tuple(int(x) for x in tag.split("x"))
spec = json.load(open(os.path.join(d, "spec.json")))
init_distributed(None, world, rank, device="cpu", timeout_s=120,
                 store=dist.FileStore(os.path.join(d, "store_" + tag), world))
mesh = make_debug_mesh(shape)
report = {"rank": rank}


def model(name):
    if name == "xc":
        cfg = xc.XCConfig("tiny", **spec["xc_cfg"])
        return (lambda p, b: xc.loss(p, b, cfg)), xc.param_specs(cfg)
    if name == "lstm":
        cfg = lstm.LSTMConfig("tiny", **spec["lstm_cfg"])
        return (lambda p, b: lstm.loss(p, b, cfg)), lstm.param_specs(cfg)
    # as the train launcher trains it: no rematerialisation
    cfg = reduced_model_cfg("qwen2-0.5b")._replace(
        n_kv_heads=spec[name]["n_kv_heads"], remat=False)
    return (lambda p, b: T.lm_loss(p, b, cfg)), T.param_specs(cfg)


def load_tree(path):
    z, out = np.load(path), {}
    for k in z.files:
        node, parts = out, k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(z[k].copy())
    return out


def save_tree(path, tree):
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + [k], v)
        else:
            flat["/".join(prefix)] = full_tensor(node).numpy()

    walk([], tree)
    if rank == 0:
        np.savez(path, **flat)


def data(name):
    return dict(np.load(os.path.join(d, ("lm" if name.startswith("lm")
                                         else name) + "_data.npz")))


def step(name):
    loss_fn, specs = model(name)
    case = spec[name]
    params = load_tree(os.path.join(d, name + "_params.npz"))
    zeros = tree_map(lambda t: np.zeros(t.shape, np.float32), params)
    state = sharded_train_state_from_numpy(
        tree_map(lambda t: t.numpy(), params), (np.int32(0), zeros, zeros),
        np.int32(0), mesh, specs)
    batch = next(ShardedBatchIterator(data(name), case["batch"],
                                      seed=case["seed"], mesh=mesh))
    with use_mesh(mesh), torch.no_grad(), CollectiveLog() as log:
        new, m = make_train_step(loss_fn, TrainConfig(**case["tc"]))(
            state, batch)
    report["step_" + name] = {"metrics": {k: float(v) for k, v in m.items()},
                              "collectives": log.records}
    save_tree(os.path.join(d, f"step_{name}_{tag}.npz"),
              {"params": new.params, "mu": new.opt.mu})


def ckpt(ck, n_steps):
    loss_fn, specs = model("xc")
    case = spec["xc"]
    params = load_tree(os.path.join(d, "xc_params.npz"))
    tr = Trainer(loss_fn, lambda g: tree_map(torch.clone, params),
                 TrainConfig(**spec["ckpt_tc"]),
                 ckpt_dir=os.path.join(d, ck), mesh=mesh, param_specs=specs)
    it = ShardedBatchIterator(data("xc"), case["batch"], seed=case["seed"],
                              mesh=mesh)
    state, hist = tr.fit(torch.Generator(), it, n_steps, log_every=1)
    report["ckpt"] = {"start": tr.start_step,
                      "losses": [h["loss"] for h in hist],
                      "placements": {k: [str(p) for p in v.placements]
                                     for k, v in state.params.items()},
                      "local_rows": {k: v.to_local().shape[0]
                                     for k, v in state.params.items()}}
    save_tree(os.path.join(d, f"ckpt_{tag}.npz"), state.params)


def iterate():
    case = spec["xc"]
    it = ShardedBatchIterator(data("xc"), case["batch"], seed=case["seed"],
                              mesh=mesh)
    out = {}
    for i in range(3):
        b = next(it)
        out.update({f"{k}{i}": v.to_local().numpy() for k, v in b.items()})
        report["iter_placements"] = {k: [str(p) for p in v.placements]
                                     for k, v in b.items()}
    report["iter_state"] = it.state_dict()
    np.savez(os.path.join(d, f"iter_{tag}_r{rank}.npz"), **out)


def psum():
    g = np.load(os.path.join(d, "psum.npz"))["g"]
    grads = {"w": torch.from_numpy(g[rank].copy())}
    out, err = compressed_psum(grads, init_error_state(grads))
    np.savez(os.path.join(d, f"psum_r{rank}.npz"), out=out["w"].numpy(),
             err=err["w"].numpy())


for task in tasks:
    kind, _, arg = task.partition(":")
    if kind == "step":
        step(arg)
    elif kind == "save":
        ckpt("ck_save", spec["ckpt_steps"])
    elif kind == "resume":
        # the (1, 2) fleet's save, copied once it is complete
        done = os.path.join(d, "ck_save", f"step_{spec['ckpt_steps']}",
                            "manifest.json")
        t_end = time.monotonic() + 120
        while not os.path.exists(done):
            assert time.monotonic() < t_end, "no checkpoint to resume"
            time.sleep(0.05)
        if rank == 0:
            shutil.copytree(os.path.join(d, "ck_save"), os.path.join(d, arg))
        dist.barrier()
        ckpt(arg, spec["resume_steps"])
    elif kind == "iter":
        iterate()
    elif kind == "psum":
        psum()
    elif kind == "production":
        try:
            make_production_mesh()
        except ValueError as e:
            report["production_mesh"] = str(e)
with open(os.path.join(d, f"report_{tag}_r{rank}.json"), "w") as f:
    json.dump(report, f)
shutdown_distributed(timeout_s=120)
"""

_JAX_SUB = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.data.pipeline import ShardedBatchIterator
from repro.optim.compression import compressed_psum, init_error_state
from repro.utils import compat

d = sys.argv[1]
devs = jax.devices()
g = np.load(os.path.join(d, "psum.npz"))["g"]
gmesh = compat.make_mesh((4,), ("pod",), devices=devs[:4],
                         axis_types=compat.auto_axis_types(1))
spec = P("pod", *([None] * (g.ndim - 1)))
fn = compat.shard_map(lambda gg, ee: compressed_psum(gg, ee, "pod"),
                      mesh=gmesh, in_specs=({"w": spec}, {"w": spec}),
                      out_specs=({"w": spec}, {"w": spec}))
with compat.set_mesh(gmesh):
    out, err = jax.jit(fn)({"w": jnp.asarray(g)},
                           init_error_state({"w": jnp.asarray(g)}))
res = {"out": np.asarray(out["w"]), "err": np.asarray(err["w"])}

z = np.load(os.path.join(d, "xc_data.npz"))
dmesh = compat.make_mesh((2, 1), ("data", "model"), devices=devs[:2],
                         axis_types=compat.auto_axis_types(2))
it = ShardedBatchIterator({k: z[k] for k in z.files}, int(sys.argv[2]),
                          seed=int(sys.argv[3]), mesh=dmesh)
for i in range(3):
    for k, v in next(it).items():
        for s in v.addressable_shards:
            r = s.index[0].start or 0
            res[f"{k}{i}_shard{r // (v.shape[0] // 2)}"] = np.asarray(s.data)
np.savez(os.path.join(d, "jax_sub.npz"), **res)
print("JAX-SUB-OK")
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=()):
    """A nested dict of arrays -> {"a/b": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _port_names(flat, name="xc"):
    """JAX's XC parameter names -> the port's (the other models share
    theirs)."""
    if name != "xc":
        return flat
    return {"/".join("embed_table" if c == "embed" else c
                     for c in k.split("/")): v for k, v in flat.items()}


def _jax_model(name):
    """(JAX config, JAX loss, JAX init params as numpy) of a case."""
    if name == "xc":
        cfg = jxc.XCConfig("tiny", **XC_CFG)
        return cfg, lambda p, b: jxc.loss(p, b, cfg), jxc.init_params(
            jax.random.PRNGKey(0), cfg)
    if name == "lstm":
        cfg = jlstm.LSTMConfig("tiny", **LSTM_CFG)
        return cfg, lambda p, b: jlstm.loss(p, b, cfg), jlstm.init_params(
            jax.random.PRNGKey(1), cfg)
    cfg = j_reduced("qwen2-0.5b")._replace(
        n_kv_heads=CASES[name]["n_kv_heads"])
    return cfg, lambda p, b: jT.lm_loss(p, b, cfg), jT.init_params(
        jax.random.PRNGKey(2), cfg)


def _port_loss(name):
    if name == "xc":
        cfg = xc.XCConfig("tiny", **XC_CFG)
        return lambda p, b: xc.loss(p, b, cfg)
    if name == "lstm":
        cfg = lstm.LSTMConfig("tiny", **LSTM_CFG)
        return lambda p, b: lstm.loss(p, b, cfg)
    cfg = reduced_model_cfg("qwen2-0.5b")._replace(
        n_kv_heads=CASES[name]["n_kv_heads"], remat=False)
    return lambda p, b: T.lm_loss(p, b, cfg)


def _data():
    d = xc_dataset(5, 256, XC_CFG["input_dim"], XC_CFG["output_dim"],
                   n_topics=8, max_in=XC_CFG["max_in"],
                   max_labels=XC_CFG["max_labels"])
    lt = lm_dataset(3, 64 * 9 * 8, LSTM_CFG["vocab"], 9, n_topics=4)
    toks = lm_dataset(0, 64 * 25 * 8, 512, 25)
    return {"xc": {"x": d.x, "labels": d.labels},
            "lstm": {"tokens": lt[:, :-1], "labels": lt[:, 1:]},
            "lm": {"tokens": toks[:, :-1], "labels": toks[:, 1:]}}


def _nested(flat):
    out = {}
    for k, v in flat.items():
        node, parts = out, k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _first_batch(arrays, batch, seed):
    perm = np.random.default_rng((seed, 0)).permutation(
        len(next(iter(arrays.values()))))
    return {k: v[perm[:batch]] for k, v in arrays.items()}


def _fleet(d, tag, tasks):
    """Start one rank a process of ``tag``'s mesh; returns the Popens."""
    world = int(np.prod([int(x) for x in tag.split("x")]))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", _WORKER, d, str(r),
                              str(world), tag, ",".join(tasks)],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _wait(procs, what):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"{what}: rank exited {p.returncode}\n" \
            f"{out[-4000:]}"
    return outs


def _reports(d, tag):
    world = int(np.prod([int(x) for x in tag.split("x")]))
    return [json.load(open(os.path.join(d, f"report_{tag}_r{r}.json")))
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every fleet of the file and the JAX subprocess, all at once (the
    (2, 1) fleet resumes the (1, 2) fleet's checkpoint once it is
    written)."""
    d = str(tmp_path_factory.mktemp("sharded_train"))
    arrays = _data()
    for name, a in arrays.items():
        np.savez(os.path.join(d, f"{name}_data.npz"), **a)
    init = {}
    for name in CASES:
        _, _, params = _jax_model(name)
        init[name] = _flat(jax.tree.map(np.asarray, params))
        np.savez(os.path.join(d, f"{name}_params.npz"),
                 **_port_names(init[name], name))
    g = (np.random.default_rng(5).normal(size=(4, 2, 300)) * 0.1).astype(
        np.float32)
    np.savez(os.path.join(d, "psum.npz"), g=g)
    spec = {name: dict(c) for name, c in CASES.items()}
    spec.update(xc_cfg=XC_CFG, lstm_cfg=LSTM_CFG, ckpt_steps=CKPT_STEPS,
                resume_steps=RESUME_STEPS, ckpt_tc=CKPT_TC)
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec, f)

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    jsub = subprocess.Popen([sys.executable, "-c", _JAX_SUB, d,
                             str(CASES["xc"]["batch"]),
                             str(CASES["xc"]["seed"])], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    f12 = _fleet(d, "1x2", ["save", "step:xc", "step:lstm", "step:lm",
                            "step:lm_kv2"])
    f22 = _fleet(d, "2x2", ["step:xc", "step:lm", "psum", "production"])
    f21 = _fleet(d, "2x1", ["step:xc", "iter", "resume:ck_21"])
    _wait(f12, "(1, 2) fleet")
    shutil.copytree(os.path.join(d, "ck_save"), os.path.join(d, "ck_one"))
    _wait(f22, "(2, 2) fleet")
    out = _wait([jsub], "JAX subprocess")[0]
    assert "JAX-SUB-OK" in out, out[-3000:]
    _wait(f21, "(2, 1) fleet")
    return {"dir": d, "init": init, "arrays": arrays,
            "reports": {t: _reports(d, t) for t in ("1x2", "2x1", "2x2")}}


# ------------------------------------------------------------- specs --

def _as_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda s: isinstance(s, JP))


def _port_tuples(tree):
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _port_tuples(v) for k, v in tree.items()}
    return type(tree)(*(_port_tuples(v) for v in tree))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-7b", "qwen3-4b"])
def test_transformer_specs_equal_jax(arch):
    from repro.configs.registry import get_config as jget
    from repro_torch.configs.registry import get_config
    jcfg, cfg = jget(arch).model_cfg, get_config(arch).model_cfg
    assert _port_tuples(T.param_specs(cfg)) == _as_tuples(
        jT.param_specs(jcfg))
    for batch in (1, 16):
        want = jT.cache_specs(jcfg, batch)
        got = T.cache_specs(cfg, batch)
        assert [tuple(s) for s in got] == [tuple(s) for s in want]


def test_xc_and_lstm_specs_equal_jax():
    got = _port_tuples(xc.param_specs(xc.XCConfig("t", **XC_CFG)))
    want = _port_names(_as_tuples(jxc.param_specs(jxc.XCConfig(
        "t", **XC_CFG))))
    assert got == want
    assert _port_tuples(lstm.param_specs(lstm.LSTMConfig(
        "t", **LSTM_CFG))) == _as_tuples(jlstm.param_specs(
            jlstm.LSTMConfig("t", **LSTM_CFG)))


class _Mesh:
    """The one attribute ``specs_to_shardings`` reads of a mesh."""
    mesh_dim_names = ("data", "model")


def test_production_mesh_needs_its_256_ranks(runs):
    for r in runs["reports"]["2x2"]:
        assert r["production_mesh"] == (
            "a (16, 16) mesh over axes ('data', 'model') needs 256 ranks; "
            "the fleet has 4")


def test_specs_to_shardings_drops_axes_the_mesh_lacks():
    specs = {"a": P(("pod", "data"), None), "b": P("pod"),
             "c": P(None, "model"), "d": {"e": P("data", ("pod", "model"))}}
    sh = specs_to_shardings(_Mesh(), specs)
    assert sh["a"].spec == P(("data",), None)
    assert sh["b"].spec == P(None)
    assert sh["c"].spec == P(None, "model")
    assert sh["d"]["e"].spec == P("data", ("model",))
    assert all(s.mesh is sh["a"].mesh for s in (sh["b"], sh["c"]))


# --------------------------------------------------------- one step --

def _one_device(name, arrays, init):
    """(JAX metrics and params, the port's) of one step on one device."""
    case = CASES[name]
    batch = _first_batch(arrays["lm" if name.startswith("lm") else name],
                         case["batch"], case["seed"])
    _, jloss, _ = _jax_model(name)
    params = _nested(init[name])
    jtc = jtrainer.TrainConfig(**case["tc"])
    jstate = jtrainer.init_state(jax.random.PRNGKey(0),
                                 lambda k: jax.tree.map(jnp.asarray, params),
                                 jtc)
    jnew, jm = jax.jit(jtrainer.make_train_step(jloss, jtc))(
        jstate, jax.tree.map(jnp.asarray, batch))
    tparams = tree_map(torch.from_numpy,
                       _nested(_port_names(init[name], name)))
    tc = TrainConfig(**case["tc"])
    state = init_state(None, lambda g: tparams, tc)
    with torch.no_grad():
        new, m = make_train_step(_port_loss(name), tc)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
    jflat = _port_names(_flat(jax.tree.map(
        np.asarray, {"params": jnew.params, "mu": jnew.opt.mu})), name)
    tflat = _flat(tree_map(lambda t: t.numpy(),
                           {"params": new.params, "mu": new.opt.mu}))
    return ({k: float(v) for k, v in jm.items()}, jflat,
            {k: float(v) for k, v in m.items()}, tflat)


_ONE: dict = {}


def _one(name, runs):
    if name not in _ONE:
        _ONE[name] = _one_device(name, runs["arrays"], runs["init"])
    return _ONE[name]


def _check_metrics(name, tag, runs):
    jm, _, tm, _ = _one(name, runs)
    for r in runs["reports"][tag]:      # every rank has the global values
        got = r["step_" + name]["metrics"]
        for k in ("loss", "grad_norm", "lr"):
            assert_close(got[k], tm[k], rtol=1e-5, atol=0,
                         what=f"{k} vs one device")
            assert_close(got[k], jm[k], rtol=1e-5, atol=0,
                         what=f"{k} vs JAX")


@pytest.mark.parametrize("name,tag", [
    ("lm", "1x2"), ("lm", "2x2"), ("xc", "1x2"), ("xc", "2x1"),
    ("xc", "2x2"), ("lstm", "1x2")])
def test_sharded_step_equals_one_device_and_jax(name, tag, runs):
    _, jp, _, tp = _one(name, runs)
    _check_metrics(name, tag, runs)
    got = np.load(os.path.join(runs["dir"], f"step_{name}_{tag}.npz"))
    assert set(got.files) == set(tp) == set(jp)
    lr = CASES[name]["tc"]["lr"]
    init = _port_names(runs["init"][name], name)
    for k in (k for k in tp if k.startswith("params/")):
        mu = k.replace("params/", "mu/", 1)
        assert not np.array_equal(got[k], init[k[len("params/"):]]), k
        for ref, what in ((tp, "one device"), (jp, "JAX")):
            if name in STRICT:
                assert_close(got[k], ref[k], rtol=0, atol=1e-6,
                             what=f"{k} vs {what}")
                continue
            assert_close(got[mu], ref[mu], rtol=0, atol=1e-7,
                         what=f"{mu} vs {what}")
            steep = (np.abs(tp[mu]) < 1e-7) | (np.abs(jp[mu]) < 1e-7)
            diff = np.abs(got[k] - ref[k])
            assert diff[~steep].max(initial=0) <= 1e-6, \
                f"{k} vs {what}: {diff[~steep].max()}"
            assert diff[steep].max(initial=0) <= 2 * lr * 1.01, \
                f"{k} vs {what}: {diff[steep].max()}"


def test_transformer_with_divided_heads_step_metrics(runs):
    _check_metrics("lm_kv2", "1x2", runs)


def _full_shapes(name):
    """Shapes that a gather must never produce whole: each model-sharded
    parameter (and a layer's slice of a stacked one) and the logits."""
    case = CASES[name]
    _, _, params = _jax_model(name)
    shapes = _nested(_port_names(_flat(jax.tree.map(
        lambda a: np.asarray(a.shape), params)), name))
    specs = (xc.param_specs(xc.XCConfig("t", **XC_CFG)) if name == "xc"
             else T.param_specs(reduced_model_cfg("qwen2-0.5b")._replace(
                 n_kv_heads=case["n_kv_heads"])))
    out = set()
    for s, shape in zip(tree_flatten(specs)[0], tree_flatten(shapes)[0]):
        if any(part is not None for part in s):
            out.add(tuple(int(n) for n in shape))
            if name != "xc" and len(s) >= 2:     # a layer's slice
                out.add(tuple(int(n) for n in shape[1:]))
    out.add((case["batch"], XC_CFG["output_dim"]) if name == "xc"
            else (case["batch"], SEQ, 512))
    return {int(np.prod(s)) for s in out}


def _gathers(records):
    return [r for r in records if "gather" in r["op"]]


def _whole(records):
    """Element counts of the gathers' outputs and the reduce-scatters'
    inputs: the tensors a collective held whole (a gather along another
    dim than 0 runs as a gather along dim 0 of a permuted tensor, so the
    count, not the shape, is what identifies it)."""
    return ({int(np.prod(r["output"])) for r in _gathers(records)}
            | {int(np.prod(s)) for r in records if "scatter" in r["op"]
               for s in r["inputs"]})


def test_xc_step_collectives_on_1x2(runs):
    """One (1, 2) step of XC: forward all-reduces of the bag [B, H], the
    log-sum-exp's max and sum [B, 1] and the gold logits [B, L]; the
    backward's one all-reduce of the bag's gradient [B, H]; one scalar
    a sharded leaf for the global norm.  Nothing else, no gather."""
    b, h, lab = CASES["xc"]["batch"], XC_CFG["hidden"], XC_CFG["max_labels"]
    for r in runs["reports"]["1x2"]:
        recs = r["step_xc"]["collectives"]
        assert [(c["op"], tuple(c["output"])) for c in recs] == [
            ("all_reduce", (b, h)), ("all_reduce", (b, 1)),
            ("all_reduce", (b, 1)), ("all_reduce", (b, lab)),
            ("all_reduce", (b, h)), ("all_reduce", ()),
            ("all_reduce", ()), ("all_reduce", ())]
        assert not _whole(recs) & _full_shapes("xc")


@pytest.mark.parametrize("name", ["lm", "lm_kv2"])
def test_transformer_step_gathers_no_parameter_or_logits(name, runs):
    """The reduced qwen2-0.5b has one KV head: on (1, 2) q, k and v are
    replicated over model before their heads are unpacked (per layer,
    three gathers of activations forward; backward, the attention
    output's gradient), and nothing the size of a sharded parameter or
    of the logits is gathered.  With two KV heads the model axis divides
    both head counts and the step gathers nothing at all."""
    full = _full_shapes(name)
    n_layers = reduced_model_cfg("qwen2-0.5b").n_layers
    for r in runs["reports"]["1x2"]:
        recs = r["step_" + name]["collectives"]
        gathers = _gathers(recs)
        assert not _whole(recs) & full
        assert {c["op"] for c in recs} <= {"all_reduce",
                                           "all_gather_into_tensor"}
        if name == "lm_kv2":
            assert gathers == []
        else:
            assert len(gathers) == 4 * n_layers
        assert sum(c["op"] == "all_reduce" for c in recs) > 0


# ----------------------------------------------------- compression --

def test_compressed_psum_4_ranks_matches_mean_and_jax(runs):
    d = runs["dir"]
    g = np.load(os.path.join(d, "psum.npz"))["g"]
    jres = np.load(os.path.join(d, "jax_sub.npz"))
    mean = g.mean(axis=0)
    for r in range(4):
        z = np.load(os.path.join(d, f"psum_r{r}.npz"))
        assert np.abs(z["out"] - mean).max() < 5e-3
        assert np.abs(z["err"]).max() > 0
        # the residual: what rank r's own int8 payload lost
        assert np.abs(z["err"]).max() < 0.5 * np.abs(g[r]).max() / 127 \
            + 1e-6
        # JAX sums the ranks' parts along an axis, the port in rank
        # order: the last bits may differ
        # (values up to 0.4: fp32 spacing there is 3e-8)
        assert_close(z["out"], jres["out"][r], rtol=0, atol=1e-7,
                     what=f"rank {r} output vs JAX")
        assert_close(z["err"], jres["err"][r], rtol=0, atol=1e-7,
                     what=f"rank {r} error state vs JAX")


# -------------------------------------------------------- iterator --

def test_iterator_shards_match_jax(runs):
    d, case = runs["dir"], CASES["xc"]
    jres = np.load(os.path.join(d, "jax_sub.npz"))
    arrays = runs["arrays"]["xc"]
    perm0 = np.random.default_rng((case["seed"], 0)).permutation(
        len(arrays["x"]))
    for r, rep in enumerate(runs["reports"]["2x1"]):
        z = np.load(os.path.join(d, f"iter_2x1_r{r}.npz"))
        assert rep["iter_state"] == {"step": 3, "seed": case["seed"]}
        assert rep["iter_placements"]["x"] == [str(Shard(0)),
                                               str(Replicate())]
        for i in range(3):
            for k in ("x", "labels"):
                np.testing.assert_array_equal(z[f"{k}{i}"],
                                              jres[f"{k}{i}_shard{r}"])
        # the global batch is one device's
        half = case["batch"] // 2
        np.testing.assert_array_equal(
            z["x0"], arrays["x"][perm0[r * half:(r + 1) * half]])


# ------------------------------------------------------ checkpoints --

def _xc_fit(runs, n_steps, ckpt_dir=None):
    """The XC case trained on one device from the shared initial
    parameters (resuming from ``ckpt_dir`` when it holds a checkpoint);
    returns the trainer and the final parameters as numpy."""
    case = CASES["xc"]
    cfg = xc.XCConfig("tiny", **XC_CFG)
    init = tree_map(torch.from_numpy,
                    _nested(_port_names(runs["init"]["xc"])))
    tr = Trainer(lambda p, b: xc.loss(p, b, cfg),
                 lambda g: tree_map(torch.clone, init),
                 TrainConfig(**CKPT_TC), ckpt_dir=ckpt_dir, device="cpu")
    it = ShardedBatchIterator(runs["arrays"]["xc"], case["batch"],
                              seed=case["seed"], device="cpu")
    state, _ = tr.fit(torch.Generator(), it, n_steps, log_every=1)
    return tr, {k: v.numpy() for k, v in state.params.items()}


def test_checkpoint_moves_between_meshes_and_to_one_device(runs):
    d = runs["dir"]
    _, want = _xc_fit(runs, RESUME_STEPS)
    saved = runs["reports"]["1x2"]
    assert all(r["ckpt"]["start"] == 0 for r in saved)
    assert saved[0]["ckpt"]["placements"]["w_out"] == [str(Replicate()),
                                                       str(Shard(0))]
    assert [r["ckpt"]["local_rows"]["w_out"] for r in saved] == [150, 150]
    resumed = runs["reports"]["2x1"]
    assert all(r["ckpt"]["start"] == CKPT_STEPS for r in resumed)
    assert len(resumed[0]["ckpt"]["losses"]) == RESUME_STEPS - CKPT_STEPS
    got21 = np.load(os.path.join(d, "ckpt_2x1.npz"))
    # one device resumes the same directory
    tr, got1 = _xc_fit(runs, RESUME_STEPS, os.path.join(d, "ck_one"))
    assert tr.start_step == CKPT_STEPS
    for k in want:
        assert_close(got21[k], want[k], rtol=0, atol=1e-6,
                     what=f"{k}: (1, 2) -> (2, 1)")
        assert_close(got1[k], want[k], rtol=0, atol=1e-6,
                     what=f"{k}: (1, 2) -> one device")


def test_jax_restores_the_sharded_save(runs):
    d = runs["dir"]
    path = os.path.join(d, "ck_save")
    step = jckpt.latest_step(path)
    assert step == CKPT_STEPS
    cfg = jxc.XCConfig("tiny", **XC_CFG)
    jtc = jtrainer.TrainConfig(**CKPT_TC)
    like = jtrainer.init_state(jax.random.PRNGKey(0),
                               lambda k: jxc.init_params(k, cfg), jtc)
    jstate, extra = jckpt.restore(path, step, like)
    assert extra["data"] == {"step": CKPT_STEPS,
                             "seed": CASES["xc"]["seed"]}
    stored = np.load(os.path.join(path, f"step_{step}", "leaves.npz"))
    leaves = jax.tree.leaves(jstate)
    assert len(leaves) == len(stored.files) == 11
    for i, leaf in enumerate(leaves):
        np.testing.assert_array_equal(np.asarray(leaf),
                                      stored[f"leaf_{i:05d}"])
    assert int(jstate.step) == CKPT_STEPS
    saved = np.load(os.path.join(d, "ckpt_1x2.npz"))
    np.testing.assert_array_equal(np.asarray(jstate.params["w_out"]),
                                  saved["w_out"])


# -------------------------------------------------------- launcher --

def test_train_launcher_devices_and_mesh_then_resume_on_another_mesh(
        tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    base = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
            "--batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    first = launch_train.main(base + ["--steps", "3", "--devices", "2",
                                      "--mesh", "1x2"])
    assert first["step"] == 3 and not first["resumed"]
    assert np.isfinite(first["loss"]) and len(first["history"]) == 1
    again = launch_train.main(base + ["--steps", "5", "--devices", "2",
                                      "--mesh", "2x1"])
    assert again["step"] == 5 and again["resumed"]
    assert [h["step"] for h in again["history"]] == [5]
