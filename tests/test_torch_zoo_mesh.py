"""The model zoo on a mesh: one step of each sharded model on real gloo
fleets of 2 and 4 ranks on the CPU ((1, 2), (2, 1) and (2, 2), all
started at once, one intra-op thread a rank) against the same step on
one device, within rtol = atol = 1e-5 (fp32): the loss and every
gradient.

* ``moe_ffn`` with the experts over ``model``: two dispatch groups (each
  data shard dispatches its own tokens) and one group (the tokens
  gathered whole first), with the balance loss;
* the MoE transformer (the reduced qwen2-moe-a2.7b: shared expert, 4
  experts top-2) with ``moe_fsdp`` (the expert tensors' d_ff over
  ``data``), two dispatch groups;
* DeepFM, AutoInt and DIEN with their row-sharded tables (the CTR train
  cells' loss), BERT4Rec (the cloze cell's sampled-softmax loss) and the
  GCN (full graph), at the reduced configs;
* a transformer decode step (forward only) over a KV cache split as the
  decode cells split it: the sequence over ``model`` (batch 16, its rows
  over ``data``) and over both axes (batch 2).

The cases are one piece of source that the test and every rank run.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.testing.parity import assert_close  # noqa: E402
from repro_torch.train.trainer import value_and_grad  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = 1e-5
TIMEOUT_S = 300
MESHES = ["1x2", "2x1", "2x2"]

# name -> (loss_fn, params, param specs, batch, batch specs[, gradient];
# without a gradient, the loss of a forward only)
_CASES = r"""
import torch
from repro_torch.configs.reduced import reduced_model_cfg
from repro_torch.launch import steps
from repro_torch.models import gnn, moe, recsys
from repro_torch.models import transformer as T
from repro_torch.utils.sharding import P


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _moe_case(groups):
    cfg = moe.MoEConfig(n_experts=8, top_k=2, d_model=16, d_ff=24,
                        n_experts_padded=8, capacity_factor=1.0,
                        n_groups=groups)
    params = moe.init_moe_params(_gen(0), cfg, device="cpu")
    g = _gen(1)
    batch = {"x": torch.randn(32, 16, generator=g),
             "w": torch.randn(32, 16, generator=g)}

    def loss(p, b):
        out, aux = moe.moe_ffn(b["x"], p, cfg)
        return (out * b["w"]).sum() + 0.1 * aux

    specs = {"router": P(None, None), "w_gate": P("model", None, None),
             "w_up": P("model", None, None),
             "w_down": P("model", None, None)}
    return loss, params, specs, batch, {"x": P("data", None),
                                        "w": P("data", None)}


def _moe_lm_case():
    cfg = reduced_model_cfg("qwen2-moe-a2.7b")._replace(moe_fsdp=True,
                                                        moe_groups=2)
    params = T.init_params(_gen(2), cfg, device="cpu")
    g = _gen(3)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 8), generator=g),
             "labels": torch.randint(0, cfg.vocab, (4, 8), generator=g)}
    return ((lambda p, b: T.lm_loss(p, b, cfg)), params, T.param_specs(cfg),
            batch, {"tokens": P("data", None), "labels": P("data", None)})


def _ctr_case(arch):
    cfg = reduced_model_cfg(arch)
    init, specs = {"deepfm": (recsys.init_deepfm, recsys.deepfm_specs),
                   "autoint": (recsys.init_autoint, recsys.autoint_specs),
                   "dien": (recsys.init_dien, recsys.dien_specs)}[arch]
    params = init(_gen(4), cfg, device="cpu")
    g = _gen(5)
    b = 16
    labels = torch.randint(0, 2, (b,), generator=g, dtype=torch.int32)
    if arch == "dien":
        hist = torch.randint(0, cfg.vocab_per_field, (b, cfg.seq_len),
                             generator=g, dtype=torch.int32)
        hist[:, -3:] = -1
        batch = {"hist": hist, "labels": labels,
                 "target": torch.randint(0, cfg.vocab_per_field, (b,),
                                         generator=g, dtype=torch.int32)}
        bs = {"hist": P("data", None), "target": P("data"),
              "labels": P("data")}
    else:
        batch = {"ids": torch.randint(0, cfg.vocab_per_field,
                                      (b, cfg.n_fields), generator=g,
                                      dtype=torch.int32), "labels": labels}
        bs = {"ids": P("data", None), "labels": P("data")}
    return ((lambda p, bb: steps.ctr_loss(p, bb, cfg)), params, specs(cfg),
            batch, bs)


def _b4r_case():
    cfg = reduced_model_cfg("bert4rec")
    params = recsys.init_bert4rec(_gen(6), cfg, device="cpu")
    g = _gen(7)
    b = 8
    seq = torch.randint(0, cfg.n_items, (b, cfg.seq_len), generator=g,
                        dtype=torch.int32)
    seq[:, :3] = -1
    batch = {"seq": seq,
             "mask_pos": torch.randint(0, cfg.seq_len, (b, steps.N_MASK),
                                       generator=g, dtype=torch.int32),
             "mask_labels": torch.randint(0, cfg.n_items, (b, steps.N_MASK),
                                          generator=g, dtype=torch.int32),
             "neg_ids": torch.randint(0, cfg.n_items, (64,), generator=g,
                                      dtype=torch.int32)}
    bs = {"seq": P("data", None), "mask_pos": P("data", None),
          "mask_labels": P("data", None), "neg_ids": P()}
    return ((lambda p, bb: steps.b4r_sampled_loss(p, bb, cfg)), params,
            recsys.bert4rec_specs(cfg), batch, bs)


def _gcn_case():
    cfg = reduced_model_cfg("gcn-cora")
    params = gnn.init_params(_gen(8), cfg, device="cpu")
    g = _gen(9)
    n, e = 40, 96
    edges = torch.randint(0, n, (e, 2), generator=g, dtype=torch.int32)
    edges[-4:] = -1
    labels = torch.randint(0, cfg.n_classes, (n,), generator=g,
                           dtype=torch.int32)
    labels[::3] = -1
    batch = {"x": torch.randn(n, cfg.d_feat, generator=g), "edges": edges,
             "labels": labels}
    return ((lambda p, bb: gnn.loss(p, bb, cfg)), params,
            gnn.param_specs(cfg), batch,
            {"x": P("data", None), "edges": P("data", None),
             "labels": P("data")})


def _decode_case(batch):
    # a decode step over a cache split by cache_specs (batch 16: the batch
    # over data, the sequence over model; batch 2: the sequence over
    # both), position 20 of 32 written: a forward only
    cfg = reduced_model_cfg("qwen2-0.5b")
    params = T.init_params(_gen(10), cfg, device="cpu")
    g = _gen(11)
    kv = (cfg.n_layers, batch, 32, cfg.n_kv_heads, cfg.head_dim)
    b = {"token": torch.randint(0, cfg.vocab, (batch,), generator=g),
         "k": torch.randn(kv, generator=g), "v": torch.randn(kv, generator=g),
         "length": torch.tensor(20, dtype=torch.int32),
         "w": torch.randn(batch, cfg.d_model, generator=g)}

    def loss(p, bb):
        h, _ = T.decode_step(p, bb["token"],
                             T.KVCache(bb["k"], bb["v"], bb["length"]), cfg)
        return (h * bb["w"]).sum() + (h * h).sum()

    cache = T.cache_specs(cfg, batch).k
    rows = P("data", None) if batch >= 16 else P(None, None)
    return (loss, params, T.param_specs(cfg), b,
            {"token": P(), "k": cache, "v": cache, "length": P(), "w": rows},
            False)


def cases():
    return {"decode_rows_over_data": _decode_case(16),
            "decode_one_seq_split": _decode_case(2),
            "moe_ffn_groups": _moe_case(2), "moe_ffn_one_group": _moe_case(1),
            "moe_transformer_fsdp": _moe_lm_case(),
            "deepfm": _ctr_case("deepfm"), "autoint": _ctr_case("autoint"),
            "dien": _ctr_case("dien"), "bert4rec": _b4r_case(),
            "gcn": _gcn_case()}
"""

_WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.distributed import init_distributed, shutdown_distributed
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.train.trainer import value_and_grad
from repro_torch.utils.sharding import (full_tensor, replicate,
                                        specs_to_shardings, to_local,
                                        use_mesh)
from repro_torch.utils.tree import tree_map

d, rank, world, tag = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    sys.argv[4]
shape = tuple(int(x) for x in tag.split("x"))
init_distributed(None, world, rank, device="cpu", timeout_s=120,
                 store=dist.FileStore(os.path.join(d, "store_" + tag), world))
mesh = make_debug_mesh(shape)
ns = {}
exec(open(os.path.join(d, "cases.py")).read(), ns)
out = {}
for name, (loss_fn, params, specs, batch, bspecs, *grad) in \
        ns["cases"]().items():
    params = tree_map(lambda t, sh: sh.place(t), params,
                      specs_to_shardings(mesh, specs))
    batch = {k: specs_to_shardings(mesh, bspecs[k]).place(v)
             for k, v in batch.items()}
    with use_mesh(mesh):
        if grad and not grad[0]:
            with torch.no_grad():
                loss, grads = to_local(replicate(loss_fn(params, batch))), {}
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
            grads = tree_map(full_tensor, grads)
    out[name] = {"loss": loss, "grads": grads}
if rank == 0:
    torch.save(out, os.path.join(d, f"report_{tag}.pt"))
shutdown_distributed(timeout_s=120)
"""


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """Every fleet's rank-0 report: all 8 ranks started at once."""
    d = tmp_path_factory.mktemp("zoo_mesh")
    (d / "cases.py").write_text(_CASES)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = []
    for tag in MESHES:
        world = int(np.prod([int(x) for x in tag.split("x")]))
        for r in range(world):
            procs.append((tag, r, subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(d), str(r), str(world),
                 tag], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
    errors = []
    for tag, r, p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"{tag} rank {r}: rc={p.returncode}\n{err[-3000:]}")
    assert not errors, "\n".join(errors)
    return {tag: torch.load(d / f"report_{tag}.pt") for tag in MESHES}


@pytest.fixture(scope="module")
def one_device():
    torch.set_num_threads(1)
    ns = {}
    exec(_CASES, ns)
    out = {}
    for name, (loss_fn, params, _, batch, _, *grad) in \
            ns["cases"]().items():
        if grad and not grad[0]:
            with torch.no_grad():
                loss, grads = loss_fn(params, batch), {}
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        out[name] = {"loss": loss, "grads": grads}
    return out


CASE_NAMES = ["decode_rows_over_data", "decode_one_seq_split",
              "moe_ffn_groups", "moe_ffn_one_group", "moe_transformer_fsdp",
              "deepfm", "autoint", "dien", "bert4rec", "gcn"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", CASE_NAMES)
def test_sharded_step_equals_one_device(fleets, one_device, mesh, name):
    got, want = fleets[mesh][name], one_device[name]
    assert_close(got["loss"], want["loss"], rtol=TOL, atol=TOL,
                 what=f"{name} {mesh} loss")
    g_leaves, w_leaves = tree_leaves(got["grads"]), tree_leaves(want["grads"])
    assert len(g_leaves) == len(w_leaves)
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        assert tuple(g.shape) == tuple(w.shape), (name, i)
        assert_close(g, w, rtol=TOL, atol=TOL, what=f"{name} {mesh} grad {i}")


def test_one_device_case_runs_without_a_mesh(one_device):
    """The cases' one-device losses are finite (the reference the fleets
    are held to)."""
    assert set(one_device) == set(CASE_NAMES)
    assert all(bool(torch.isfinite(v["loss"])) for v in one_device.values())

