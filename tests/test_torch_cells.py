"""The port's cells (``repro_torch.launch.steps``) against the JAX
package's (``repro.launch.steps``).

* ``all_cells()`` gives the same 40 (arch, shape) pairs in both.
* Every cell on a one-device (1, 1) mesh, and one cell a family on a
  (2, 2) mesh (JAX on 4 host devices, the port on a fake group of 4
  ranks), each package in a subprocess of its own: ``arch_id``,
  ``shape_name``, ``comment`` and ``donate_state`` equal, ``model_flops``
  within relative 1e-12, every arg leaf's global shape and dtype (JAX's
  ``ShapeDtypeStruct`` against the port's ``meta`` tensor, matched by key
  path) and every leaf's sharding spec.  The sampled GCN cell's JAX
  ``key`` (uint32 [2]) is the port's ``seed`` (int64 []): the one leaf
  that differs by design.  The port's args are ``meta`` tensors: no
  memory is allocated.
* Each kind's ``fn`` through both packages at the reduced configs, the
  JAX weights carried over as numpy (``repro_torch.convert``): the CTR
  serve, retrieval and loss functions and the BERT4Rec sampled loss
  (with their gradients) within rtol = atol = 1e-5 (fp32); BERT4Rec
  serve and LM decode (tp = 1) with their LSS top-k: logits within the
  tolerance of their model and ids exact on rows whose hash margin
  exceeds 1e-5; LM prefill, and one LM and one GCN train step (loss,
  gradient norm and Adam's first moment) within rtol = atol = 1e-4 for
  the LM (two fp32 layers, as ``test_torch_transformer.py``) and 1e-5
  for the GCN.  The sampled GCN cell: one step's state shapes and a
  finite loss, and the loss of one fixed sampled block through both
  packages.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduced import reduced_model_cfg as j_reduced  # noqa: E402
from repro.configs.registry import all_cells as j_all_cells  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.core import lss as jlss  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import recsys as jrecsys  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.utils import compat  # noqa: E402
from repro_torch.configs.reduced import reduced_model_cfg  # noqa: E402
from repro_torch.configs.registry import all_cells, get_config  # noqa: E402
from repro_torch.convert import (tensor_from_numpy,  # noqa: E402
                                 transformer_params_from_numpy)
from repro_torch.core.lss import LSSIndex  # noqa: E402
from repro_torch.core.tables import LSSTables  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import gnn, recsys  # noqa: E402
from repro_torch.testing.parity import (assert_close,  # noqa: E402
                                        assert_ints_equal, margin_rows)
from repro_torch.utils.tree import (tree_flatten, tree_leaves,  # noqa: E402
                                    tree_map, tree_unflatten)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = 1e-5
TOL_LM = 1e-4
MESH_CELLS = [("qwen2-0.5b", "decode_32k"), ("bert4rec", "serve_p99"),
              ("deepfm", "serve_p99"), ("gcn-cora", "molecule")]

# both dumps: {"shape/arch/cell": {fields, "leaves": {path: [shape, dtype]},
# "specs": {path: spec}}} with one path format (jax's keystr)
_COMMON = r"""
import json, sys

def record(cell, leaves, specs):
    return {"arch_id": cell.arch_id, "shape_name": cell.shape_name,
            "comment": cell.comment, "donate_state": bool(cell.donate_state),
            "model_flops": float(cell.model_flops), "leaves": leaves,
            "specs": specs}
"""

_JAX_DUMP = _COMMON + r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from repro.configs.registry import all_cells
from repro.launch.steps import build_cell
from repro.utils import compat

def spec_of(sh):
    return [list(p) if isinstance(p, tuple) else p for p in sh.spec]

out = {}
for shape, cells in (((1, 1), all_cells()), ((2, 2), json.loads(sys.argv[2]))):
    n = shape[0] * shape[1]
    mesh = compat.make_mesh(shape, ("data", "model"),
                            devices=jax.devices()[:n],
                            axis_types=compat.auto_axis_types(2))
    for a, s in cells:
        c = build_cell(a, s, mesh)
        leaves = {jax.tree_util.keystr(p): [list(x.shape), str(x.dtype)]
                  for p, x in jax.tree_util.tree_flatten_with_path(c.args)[0]
                  if hasattr(x, "shape") and hasattr(x, "dtype")}
        specs = {jax.tree_util.keystr(p): spec_of(x)
                 for p, x in jax.tree_util.tree_flatten_with_path(
                     c.in_shardings)[0] if hasattr(x, "spec")}
        out[f"{shape[0]}x{shape[1]}/{a}/{s}"] = record(c, leaves, specs)
json.dump(out, open(sys.argv[1], "w"))
"""

_PORT_DUMP = _COMMON + r"""
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.registry import all_cells
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_cell

def walk(node, path, out):
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            walk(node[k], f"{path}['{k}']", out)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f in node._fields:
            walk(getattr(node, f), f"{path}.{f}", out)
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            walk(v, f"{path}[{i}]", out)
    else:
        out[path] = node

def spec_of(sh):
    return [list(p) if isinstance(p, tuple) else p for p in sh.spec]

out = {}
for shape, cells in (((1, 1), all_cells()), ((2, 2), json.loads(sys.argv[2]))):
    dist.init_process_group("fake", rank=0, world_size=shape[0] * shape[1],
                            store=FakeStore())
    mesh = make_mesh(shape, ("data", "model"))
    for a, s in cells:
        c = build_cell(a, s, mesh)
        args, shs = {}, {}
        walk(c.args, "", args)
        walk(c.in_shardings, "", shs)
        leaves = {p: [list(x.shape), str(x.dtype).replace("torch.", "")]
                  for p, x in args.items() if isinstance(x, torch.Tensor)}
        assert all(x.is_meta for x in args.values()
                   if isinstance(x, torch.Tensor)), (a, s)
        specs = {p: spec_of(x) for p, x in shs.items()
                 if hasattr(x, "spec") and p in leaves}
        out[f"{shape[0]}x{shape[1]}/{a}/{s}"] = record(c, leaves, specs)
    dist.destroy_process_group()
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Both packages' cell records, made in two subprocesses at once."""
    d = tmp_path_factory.mktemp("cells")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    cells = json.dumps(MESH_CELLS)
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code, str(d / f"{name}.json"), cells],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, code in (("jax", _JAX_DUMP),
                                      ("port", _PORT_DUMP))}
    out = {}
    for name, p in procs.items():
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, f"{name} dump failed:\n{err[-4000:]}"
        out[name] = json.load(open(d / f"{name}.json"))
    return out


def test_all_cells_equal():
    assert all_cells() == j_all_cells()
    assert len(all_cells()) == 40


def _keys():
    return ([f"1x1/{a}/{s}" for a, s in j_all_cells()]
            + [f"2x2/{a}/{s}" for a, s in MESH_CELLS])


# the sampled GCN cell's JAX key is the port's seed (see the docstring)
_RENAMED = {"[1]['key']": "[1]['seed']"}
# JAX's LSSIndex and LSSTables are pytrees of their own, whose key paths
# are flat indices: the port's are their fields
_INDEX_FIELDS = ("theta", "tables", "w_bucketed", "w_scale")
_TABLE_FIELDS = ("table_ids", "n_dropped")


def _jax_path(p: str) -> str:
    p = _RENAMED.get(p, p)
    m = re.search(r"\[<flat index (\d)>\](\[<flat index (\d)>\])?$", p)
    if not m:
        return p
    field = "." + _INDEX_FIELDS[int(m.group(1))]
    if m.group(3) is not None:
        field += "." + _TABLE_FIELDS[int(m.group(3))]
    return p[:m.start()] + field


@pytest.mark.parametrize("key", _keys())
def test_cell_matches_jax(dumps, key):
    j, t = dumps["jax"][key], dumps["port"][key]
    for f in ("arch_id", "shape_name", "comment", "donate_state"):
        assert t[f] == j[f], (key, f)
    assert t["model_flops"] == pytest.approx(j["model_flops"], rel=1e-12)
    jl = {_jax_path(p): v for p, v in j["leaves"].items()}
    assert set(t["leaves"]) == set(jl), (key, set(t["leaves"]) ^ set(jl))
    for p, (shape, dtype) in jl.items():
        if p in _RENAMED.values():
            assert t["leaves"][p] == [[], "int64"]
            continue
        assert t["leaves"][p] == [shape, dtype], (key, p)
    js = {_jax_path(p): v for p, v in j["specs"].items()
          if _jax_path(p) in jl}
    assert t["specs"] == js, key


# ------------------------------------------------------------ fn parity --

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _j_cell(arch, shape, dims, **cfg):
    """JAX's cell at the reduced config (with ``cfg``'s fields) and
    ``dims`` on a (1, 1) mesh."""
    spec = j_get_config(arch)
    sh = spec.shape(shape)
    spec = spec._replace(model_cfg=j_reduced(arch)._replace(**cfg),
                         shapes={shape: sh._replace(
                             dims={**sh.dims, **dims})})
    orig = jsteps.get_config
    jsteps.get_config = lambda a: spec
    try:
        return jsteps.build_cell(arch, shape, _jmesh())
    finally:
        jsteps.get_config = orig


def _t_cell(arch, shape, dims, **cfg):
    spec = get_config(arch)
    spec = spec._replace(model_cfg=reduced_model_cfg(arch)._replace(**cfg))
    orig = steps.get_config
    steps.get_config = lambda a: spec
    try:
        return steps.build_cell(arch, shape, None, dims=dims)
    finally:
        steps.get_config = orig


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch(tree):
    return tree_map(lambda a: tensor_from_numpy(a, torch.device("cpu")),
                    tree)


def _jcall(fn, *args):
    with compat.set_mesh(_jmesh()):
        return jax.jit(fn)(*args)


_J_CTR_INIT = {"deepfm": jrecsys.init_deepfm, "autoint": jrecsys.init_autoint,
               "dien": jrecsys.init_dien}


def _ctr_batch(arch, cfg, b, seed=1):
    rng = np.random.default_rng(seed)
    y = (rng.random(b) < 0.3).astype(np.int32)
    if arch == "dien":
        hist = rng.integers(-1, cfg.vocab_per_field, (b, cfg.seq_len))
        hist[:, -3:] = -1
        return {"hist": hist.astype(np.int32),
                "target": rng.integers(0, cfg.vocab_per_field, b).astype(
                    np.int32), "labels": y}
    return {"ids": rng.integers(0, cfg.vocab_per_field,
                                (b, cfg.n_fields)).astype(np.int32),
            "labels": y}


def _grads_t(loss_fn, params):
    """The loss and its gradient, leaves in JAX's order."""
    leaves, treedef = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss = loss_fn(tree_unflatten(treedef, live))
    return loss, torch.autograd.grad(loss, live)


@pytest.mark.parametrize("arch", ["deepfm", "autoint", "dien"])
def test_ctr_serve_retrieval_and_loss_fns(arch):
    cfg = j_reduced(arch)
    jp = _np(_J_CTR_INIT[arch](jax.random.PRNGKey(0),
                               cfg._replace(unroll_scan=True)))
    tp = _to_torch(jp)
    batch = _ctr_batch(arch, cfg, 16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    # serve
    jc, tc = _j_cell(arch, "serve_p99", {"batch": 16}), \
        _t_cell(arch, "serve_p99", {"batch": 16})
    serve_j = {k: v for k, v in jb.items() if k != "labels"}
    serve_t = {k: v for k, v in tb.items() if k != "labels"}
    assert_close(tc.fn(tp, serve_t), np.asarray(_jcall(jc.fn, jp, serve_j)),
                 rtol=TOL, atol=TOL, what=f"{arch} serve")
    # retrieval: one user against 64 candidates
    jc = _j_cell(arch, "retrieval_cand", {"n_candidates": 64})
    tc = _t_cell(arch, "retrieval_cand", {"n_candidates": 64})
    rng = np.random.default_rng(2)
    user = (rng.integers(0, cfg.vocab_per_field, (1, cfg.seq_len))
            if arch == "dien"
            else rng.integers(0, cfg.vocab_per_field, (1, cfg.n_fields))
            ).astype(np.int32)
    cand = rng.integers(0, cfg.vocab_per_field, 64).astype(np.int32)
    assert_close(tc.fn(tp, torch.from_numpy(user), torch.from_numpy(cand)),
                 np.asarray(_jcall(jc.fn, jp, jnp.asarray(user),
                                   jnp.asarray(cand))),
                 rtol=TOL, atol=TOL, what=f"{arch} retrieval")
    # the train cells' loss and its gradient
    tcfg = reduced_model_cfg(arch)._replace(unroll_scan=True)
    jl, jg = jax.value_and_grad(
        lambda p: jsteps._ctr_loss(p, jb, cfg._replace(unroll_scan=True)))(jp)
    tl, tg = _grads_t(lambda p: steps.ctr_loss(p, tb, tcfg), tp)
    assert_close(tl, np.asarray(jl), rtol=TOL, atol=TOL, what="ctr loss")
    for g, w in zip(tg, jax.tree.leaves(jg)):
        assert_close(g, np.asarray(w), rtol=TOL, atol=TOL, what="ctr grad")


def _b4r_params(**kw):
    cfg = j_reduced("bert4rec")._replace(**kw)
    jp = _np(jrecsys.init_bert4rec(jax.random.PRNGKey(0), cfg))
    return cfg, jp, _to_torch(jp)


def test_b4r_sampled_loss_and_gradient():
    cfg, jp, tp = _b4r_params()
    rng = np.random.default_rng(3)
    b = 8
    seq = rng.integers(0, cfg.n_items, (b, cfg.seq_len))
    seq[:, :3] = -1
    batch = {"seq": seq.astype(np.int32),
             "mask_pos": rng.integers(0, cfg.seq_len,
                                      (b, steps.N_MASK)).astype(np.int32),
             "mask_labels": rng.integers(0, cfg.n_items,
                                         (b, steps.N_MASK)).astype(np.int32),
             "neg_ids": rng.integers(0, cfg.n_items, 64).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(
        lambda p: jsteps._b4r_sampled_loss(p, jb, cfg))(jp)
    tl, tg = _grads_t(lambda p: steps.b4r_sampled_loss(
        p, tb, reduced_model_cfg("bert4rec")), tp)
    assert_close(tl, np.asarray(jl), rtol=TOL, atol=TOL, what="b4r loss")
    for g, w in zip(tg, jax.tree.leaves(jg)):
        assert_close(g, np.asarray(w), rtol=TOL, atol=TOL, what="b4r grad")


def _j_index(w_aug, lss, theta):
    """JAX's one-shard index over ``w_aug`` (bf16 slabs), stacked [1, ...]."""
    m = w_aug.shape[0]
    cfg = lss._replace(capacity=lss.resolve_capacity(m), slab_dtype="bf16")
    idx = jlss.build_index(jnp.asarray(w_aug), jnp.asarray(theta), cfg)
    return jax.tree.map(lambda x: x[None], idx), idx


def _t_index(jidx):
    t = jidx.tables
    one = lambda a: tensor_from_numpy(np.asarray(a), torch.device("cpu"))
    return LSSIndex(one(jidx.theta),
                    LSSTables(one(t.table_ids), one(t.n_dropped), t.k_bits,
                              t.n_tables, t.capacity),
                    one(jidx.w_bucketed))


def _check_topk(got, want, q, theta, tol, what):
    rows = margin_rows(q, theta[0])
    assert rows.mean() > 0.5, what
    assert_close(got[0], np.asarray(want[0]), rtol=tol, atol=tol,
                 rows=rows, what=f"{what} logits")
    assert_ints_equal(got[1], np.asarray(want[1]), rows=rows,
                      what=f"{what} ids")


def test_b4r_serve_fn_tp1():
    # 20,000 items: K = 12's 4,096 buckets then hold 16 slots each, more
    # than the top-10
    cfg, jp, tp = _b4r_params(n_items=20_000)
    b = 16
    jc = _j_cell("bert4rec", "serve_p99", {"batch": b}, n_items=20_000)
    tc = _t_cell("bert4rec", "serve_p99", {"batch": b}, n_items=20_000)
    spec = j_get_config("bert4rec")
    d_aug = cfg.embed_dim + 1
    theta = np.random.default_rng(4).standard_normal(
        (d_aug, spec.lss.k_bits * spec.lss.n_tables)).astype(np.float32)
    w_aug = np.concatenate([np.asarray(jp["head"]),
                            np.zeros((cfg.n_items, 1), np.float32)], 1)
    jidx, one = _j_index(w_aug, spec.lss, theta)
    tidx = steps.tensor_map(lambda x: x[None], _t_index(one))
    seq = np.random.default_rng(5).integers(
        0, cfg.n_items, (b, cfg.seq_len)).astype(np.int32)
    want = _jcall(jc.fn, jp, jnp.asarray(seq), jidx)
    got = tc.fn(tp, torch.from_numpy(seq), tidx)
    hidden = jrecsys.bert4rec_encode(jp, jnp.asarray(seq), cfg)[:, -1]
    q = np.concatenate([np.asarray(hidden), np.zeros((b, 1), np.float32)], 1)
    _check_topk(got, want, q, np.asarray(jidx.theta), TOL, "b4r serve")


def _lm_params(arch="qwen2-0.5b"):
    cfg = j_reduced(arch)
    jp = _np(jT.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, jp, transformer_params_from_numpy(
        jp, reduced_model_cfg(arch), "cpu")


def test_lm_prefill_fn():
    cfg, jp, tp = _lm_params()
    gb, sl = 2, 16
    jc = _j_cell("qwen2-0.5b", "prefill_32k", {"global_batch": gb,
                                               "seq_len": sl})
    tc = _t_cell("qwen2-0.5b", "prefill_32k", {"global_batch": gb,
                                               "seq_len": sl})
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (gb, sl)
                                               ).astype(np.int32)
    jh, jcache = _jcall(jc.fn, jp, jnp.asarray(tokens))
    th, tcache = tc.fn(tp, torch.from_numpy(tokens))
    assert_close(th, np.asarray(jh), rtol=TOL_LM, atol=TOL_LM,
                 what="prefill hidden")
    assert_close(tcache.k, np.asarray(jcache.k), rtol=TOL_LM, atol=TOL_LM,
                 what="prefill k")
    assert_close(tcache.v, np.asarray(jcache.v), rtol=TOL_LM, atol=TOL_LM,
                 what="prefill v")


def test_lm_decode_fn_tp1():
    cfg, jp, tp = _lm_params()
    gb, sl = 4, 32
    jc = _j_cell("qwen2-0.5b", "decode_32k", {"global_batch": gb,
                                              "seq_len": sl})
    tc = _t_cell("qwen2-0.5b", "decode_32k", {"global_batch": gb,
                                              "seq_len": sl})
    rng = np.random.default_rng(7)
    kv = (cfg.n_layers, gb, sl, cfg.n_kv_heads, cfg.head_dim)
    k = rng.standard_normal(kv).astype(np.float32)
    v = rng.standard_normal(kv).astype(np.float32)
    jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    length = sl - 1
    token = rng.integers(0, cfg.vocab, gb).astype(np.int32)
    spec = j_get_config("qwen2-0.5b")
    head = np.asarray(jp["embed"] if cfg.tie_embeddings else jp["lm_head"],
                      np.float32)
    w_aug = np.concatenate([head, np.zeros((cfg.vocab, 1), np.float32)], 1)
    theta = rng.standard_normal(
        (cfg.d_model + 1, spec.lss.k_bits * spec.lss.n_tables)
    ).astype(np.float32)
    jidx, one = _j_index(w_aug, spec.lss, theta)
    tidx = steps.tensor_map(lambda x: x[None], _t_index(one))
    jcache = jT.KVCache(k=jk, v=jv, length=jnp.asarray(length, jnp.int32))
    want = _jcall(jc.fn, jp, jnp.asarray(token), jcache, jidx)
    tcache = steps.T.KVCache(
        tensor_from_numpy(np.asarray(jk), torch.device("cpu")),
        tensor_from_numpy(np.asarray(jv), torch.device("cpu")),
        torch.tensor(length, dtype=torch.int32))
    got = tc.fn(tp, torch.from_numpy(token), tcache, tidx)
    hidden, _ = jT.decode_step(jp, jnp.asarray(token), jT.KVCache(
        k=jk, v=jv, length=jnp.asarray(length, jnp.int32)), cfg)
    q = np.concatenate([np.asarray(hidden, np.float32),
                        np.zeros((gb, 1), np.float32)], 1)
    _check_topk(got, want, q, np.asarray(jidx.theta), TOL_LM, "lm decode")
    assert_close(got[2].k.float(), np.asarray(want[2].k, np.float32),
                 rtol=TOL_LM, atol=1e-2, what="decode k cache (bf16)")


def _j_state(params):
    from repro.optim import adamw_init
    from repro.train.trainer import TrainState
    return TrainState(params, adamw_init(params, jnp.float32),
                      jnp.zeros((), jnp.int32))


def _t_state(params):
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.trainer import TrainState
    return TrainState(params, adamw_init(params, torch.float32),
                      torch.zeros((), dtype=torch.int32))


def _check_step(got, want, tol, what):
    (t_state, t_m), (j_state, j_m) = got, want
    for key in ("loss", "grad_norm"):
        assert_close(t_m[key], np.asarray(j_m[key]), rtol=tol, atol=tol,
                     what=f"{what} {key}")
    # Adam's first moment is 0.1 g: the gradient, without the first
    # update's sign sensitivity at near-zero elements
    for t, j in zip(tree_leaves(t_state.opt.mu),
                    jax.tree.leaves(j_state.opt.mu)):
        assert_close(t, np.asarray(j), rtol=tol, atol=tol / 10,
                     what=f"{what} mu")


def test_lm_train_step():
    cfg, jp, tp = _lm_params()
    gb, sl = 2, 16
    jc = _j_cell("qwen2-0.5b", "train_4k", {"global_batch": gb,
                                            "seq_len": sl})
    tc = _t_cell("qwen2-0.5b", "train_4k", {"global_batch": gb,
                                            "seq_len": sl})
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, cfg.vocab, (gb, sl)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (gb, sl)).astype(np.int32)}
    want = _jcall(jc.fn, _j_state(jax.tree.map(jnp.asarray, jp)),
                  {k: jnp.asarray(v) for k, v in batch.items()})
    got = tc.fn(_t_state(tp), {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    _check_step(got, want, TOL_LM, "lm train")


def _gnn_graph(cfg, n, e, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, cfg.d_feat)).astype(np.float32)
    edges = rng.integers(0, n, (e, 2)).astype(np.int32)
    edges[-3:] = -1
    labels = rng.integers(0, cfg.n_classes, n).astype(np.int32)
    labels[::3] = -1
    return {"x": x, "edges": edges, "labels": labels}


def test_gnn_train_step():
    cfg = j_reduced("gcn-cora")
    n, e = 40, 96
    dims = {"n_nodes": n, "n_edges": e, "d_feat": cfg.d_feat,
            "n_classes": cfg.n_classes}
    jc = _j_cell("gcn-cora", "full_graph_sm", dims)
    tc = _t_cell("gcn-cora", "full_graph_sm", dims)
    jp = _np(jgnn.init_params(jax.random.PRNGKey(0), cfg))
    batch = _gnn_graph(cfg, n, e)
    want = _jcall(jc.fn, _j_state(jax.tree.map(jnp.asarray, jp)),
                  {k: jnp.asarray(v) for k, v in batch.items()})
    got = tc.fn(_t_state(_to_torch(jp)),
                {k: torch.from_numpy(v) for k, v in batch.items()})
    _check_step(got, want, TOL, "gcn train")


def test_gnn_minibatch_cell_and_a_fixed_block():
    cfg = reduced_model_cfg("gcn-cora")
    dims = {"n_nodes": 50, "n_edges": 200, "batch_nodes": 4,
            "fanout": (3, 2), "d_feat": cfg.d_feat,
            "n_classes": cfg.n_classes}
    tc = _t_cell("gcn-cora", "minibatch_lg", dims)
    state, batch = tc.init_args(torch.Generator().manual_seed(0), "cpu")
    shapes = [tuple(t.shape) for t in
              tree_leaves(state.params)]
    new, metrics = tc.fn(state, batch)
    assert [tuple(t.shape) for t in
            tree_leaves(new.params)] == shapes
    assert bool(torch.isfinite(metrics["loss"]))
    # one fixed sampled block through both packages
    nodes, edges = gnn.sampled_subgraph(
        torch.Generator().manual_seed(1), batch["indptr"], batch["indices"],
        batch["seeds"], dims["fanout"])
    assert nodes.shape[0] == 4 * (1 + 3 + 3 * 2)
    jcfg = j_reduced("gcn-cora")
    jp = _np(jgnn.init_params(jax.random.PRNGKey(0), jcfg))
    x = batch["x"][nodes].numpy()
    labels = np.full(nodes.shape[0], -1, np.int32)
    labels[:4] = batch["seed_labels"].numpy()
    blk = {"x": x, "edges": edges.numpy(), "labels": labels}
    want = jgnn.loss(jax.tree.map(jnp.asarray, jp),
                     {k: jnp.asarray(v) for k, v in blk.items()}, jcfg)
    got = gnn.loss(_to_torch(jp), {k: torch.from_numpy(v)
                                   for k, v in blk.items()}, cfg)
    assert_close(got, np.asarray(want), rtol=TOL, atol=TOL,
                 what="sampled block loss")

