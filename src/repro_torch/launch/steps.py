"""Cell builders: (architecture x input shape) -> a step to trace or run
(counterpart of ``repro.launch.steps``).

``build_cell(arch_id, shape_name, mesh)`` returns a :class:`Cell`: the
step function, its example args as ``meta`` tensors (no memory is
allocated: arctic-480b's parameters alone are 476 GB in bf16), the
``NamedSharding`` of each arg leaf on ``mesh`` (the port's, spec for spec
the JAX package's), the analytic useful FLOPs, and ``init_args``, which
draws the same args for real.  The dry-run (``repro_torch.launch.dryrun``)
traces ``fn`` on fake tensors laid out by the shardings; ``chip_smoke.py``
runs it on the card.

Run ``fn`` inside ``utils.sharding.use_mesh(mesh)`` on args laid out by
``in_shardings`` (``NamedSharding.place``); on one device, plain tensors
do.

Against the JAX module: ``flops_correction`` is gone (it added back the
FLOPs XLA's cost analysis missed by counting a scan body once; eager
torch runs, and the dry-run traces, every layer and every attention
chunk), and so is ``lm_impl`` (torch has no scan: the layers are a
Python loop).  The sampled GCN cell takes a seed tensor where JAX takes
a key, and draws with ``gnn.sampled_subgraph``; its draws are not JAX's.
The decode cells' KV cache ``length`` is an int32 scalar tensor, and
the LSS index stack is an ``LSSIndex`` whose leaves carry a leading
``[tp]`` shard axis, split over ``model``.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.registry import get_config
from repro_torch.core.lss import LSSConfig, LSSIndex
from repro_torch.core.sharded import build_local_index, sharded_lss_predict
from repro_torch.core.simhash import augment_neurons, init_hyperplanes
from repro_torch.core.tables import LSSTables
from repro_torch.distributed import ServingMesh
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWState, adamw_init
from repro_torch.train.trainer import (TrainConfig, TrainState,
                                       make_train_step, state_shardings)
from repro_torch.utils.sharding import (NamedSharding, P, full_tensor,
                                        is_dtensor, specs_to_shardings,
                                        to_local)
from repro_torch.utils.tree import tree_flatten, tree_unflatten

__all__ = ["Cell", "build_cell", "eval_shape", "tensor_map",
           "ctr_logits", "ctr_loss", "b4r_sampled_loss", "N_MASK", "N_NEG"]

f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32


class Cell(NamedTuple):
    arch_id: str
    shape_name: str
    fn: Callable
    args: tuple                 # meta tensors / trees thereof
    in_shardings: tuple
    model_flops: float          # analytic useful FLOPs (6ND style)
    comment: str = ""
    donate_state: bool = False  # train cells write the new state in place
    # (generator, device) -> the args, drawn for real and whole
    init_args: Callable | None = None


def tensor_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (and the matching leaves
    of ``rest``); other leaves (an index's ints) stay as they are."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    out = [fn(x, *o) if isinstance(x, torch.Tensor) else x
           for x, *o in zip(leaves, *others)]
    return tree_unflatten(treedef, out)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def eval_shape(fn: Callable, *args, **kwargs):
    """``fn``'s result with every tensor a ``meta`` tensor of its shape and
    dtype: ``fn`` runs under a ``FakeTensorMode`` (its draws allocate
    nothing), the counterpart of ``jax.eval_shape``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        out = fn(*args, **kwargs)
    return tensor_map(lambda t: _meta(t.shape, t.dtype), out)


def _pad_up(n: int, mult: int) -> int:
    """A dim the mesh splits evenly; models tolerate padded rows (-1 ids
    / zero rows) by construction."""
    return -(-n // mult) * mult


def _axis(mesh, name: str) -> int:
    if mesh is None:
        return 1
    names = tuple(mesh.mesh_dim_names)
    return mesh.size(names.index(name)) if name in names else 1


# the shardings of a cell built without a mesh (one device) are None
def _ns(mesh, spec: P):
    return None if mesh is None else NamedSharding(mesh, spec)


def _specs(mesh, specs):
    return None if mesh is None else specs_to_shardings(mesh, specs)


def _state_sh(mesh, specs):
    return None if mesh is None else state_shardings(mesh, specs)


def _sharded(mesh, tree, spec_of):
    if mesh is None:
        return None
    return tensor_map(lambda t: NamedSharding(mesh, spec_of(t)), tree)


def _data_spec(mesh, tree):
    return _sharded(mesh, tree,
                    lambda t: P("data", *([None] * (t.dim() - 1))))


def _state_meta(params, opt_dtype) -> TrainState:
    zeros = lambda t: _meta(t.shape, opt_dtype)
    return TrainState(params, AdamWState(_meta((), i32),
                                         tensor_map(zeros, params),
                                         tensor_map(zeros, params)),
                      _meta((), i32))


def _fresh_state(params, opt_dtype) -> TrainState:
    opt = adamw_init(params, opt_dtype)
    return TrainState(params, opt, torch.zeros((), dtype=i32,
                                               device=opt.step.device))


def _ints(gen, high, shape, device, low=0) -> torch.Tensor:
    return torch.randint(low, high, shape, generator=gen,
                         device=gen.device, dtype=i32).to(device)


def _normal(gen, shape, device, dtype=f32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).to(
        device=device, dtype=dtype)


# ===================================================================== LM ==

def _lm_params_meta(cfg):
    return eval_shape(lambda: T.init_params(torch.Generator(), cfg,
                                            device="cpu"))


def _lm_train_cell(spec: ArchSpec, shape, mesh) -> Cell:
    cfg = spec.model_cfg
    opt_dtype = bf16 if "arctic" in spec.arch_id else f32
    tc = TrainConfig(opt_state_dtype=opt_dtype, microbatches=1)
    loss_fn = functools.partial(_lm_loss_fn, cfg=cfg)
    step = make_train_step(loss_fn, tc, donate=True)
    gb, sl = shape.dims["global_batch"], shape.dims["seq_len"]
    state = _state_meta(_lm_params_meta(cfg), opt_dtype)
    batch = {"tokens": _meta((gb, sl), i32), "labels": _meta((gb, sl), i32)}
    sh_state = _state_sh(mesh, T.param_specs(cfg))
    sh_batch = _data_spec(mesh, batch)
    # 6ND + attention term 12*L*n*h*S per token (causal halves it)
    n_active = cfg.active_param_count()
    tokens = gb * sl
    attn = 2 * 2 * cfg.n_layers * cfg.n_heads * cfg.head_dim * sl / 2
    mf = 3 * (2 * n_active + attn) * tokens    # fwd + 2x bwd

    def init(gen, device):
        params = T.init_params(gen, cfg, device=device)
        return (_fresh_state(params, opt_dtype),
                {"tokens": _ints(gen, cfg.vocab, (gb, sl), device),
                 "labels": _ints(gen, cfg.vocab, (gb, sl), device)})

    return Cell(spec.arch_id, shape.name, step, (state, batch),
                (sh_state, sh_batch), mf, "train_step w/ AdamW",
                donate_state=True, init_args=init)


def _lm_loss_fn(params, batch, cfg):
    return T.lm_loss(params, batch, cfg)


def _lm_prefill_cell(spec: ArchSpec, shape, mesh) -> Cell:
    cfg = spec.model_cfg
    gb, sl = shape.dims["global_batch"], shape.dims["seq_len"]

    def fn(params, tokens):
        hidden, cache = T.prefill(params, tokens, cfg, max_len=sl)
        return hidden[:, -1], cache

    params = _lm_params_meta(cfg)
    tokens = _meta((gb, sl), i32)
    sh = (_specs(mesh, T.param_specs(cfg)),
          _ns(mesh, P("data", None)))
    n_active = cfg.active_param_count()
    attn = 2 * 2 * cfg.n_layers * cfg.n_heads * cfg.head_dim * sl / 2
    mf = (2 * n_active + attn) * gb * sl

    def init(gen, device):
        return (T.init_params(gen, cfg, device=device),
                _ints(gen, cfg.vocab, (gb, sl), device))

    return Cell(spec.arch_id, shape.name, fn, (params, tokens), sh, mf,
                "prefill -> (last hidden, kv cache)", init_args=init)


def _lss_index_meta(lss: LSSConfig, m_local: int, d_aug: int, tp: int
                    ) -> LSSIndex:
    """The stacked per-shard LSS index (``[tp, ...]`` leaves), as meta
    tensors."""
    cap = lss.resolve_capacity(m_local)
    nb = 2 ** lss.k_bits
    tables = LSSTables(table_ids=_meta((tp, lss.n_tables, nb, cap), i32),
                       n_dropped=_meta((tp, lss.n_tables), i32),
                       k_bits=lss.k_bits, n_tables=lss.n_tables,
                       capacity=cap)
    return LSSIndex(theta=_meta((tp, d_aug, lss.k_bits * lss.n_tables), f32),
                    tables=tables,
                    w_bucketed=_meta((tp, lss.n_tables, nb, cap, d_aug),
                                     bf16))


def _lss_index_init(gen, w_aug: torch.Tensor, lss: LSSConfig, tp: int
                    ) -> LSSIndex:
    """Each of ``tp`` vocab shards' index over its ``ceil(m / tp)`` rows of
    ``w_aug`` (one theta for every shard, bf16 slabs), stacked."""
    m, d_aug = w_aug.shape
    m_local = -(-m // tp)
    cfg = lss._replace(capacity=lss.resolve_capacity(m_local),
                       slab_dtype="bf16")
    theta = init_hyperplanes(gen, d_aug, lss.k_bits, lss.n_tables,
                             device=w_aug.device)
    shards = [build_local_index(w_aug[s * m_local:(s + 1) * m_local], theta,
                                cfg) for s in range(tp)]
    stack = lambda *xs: torch.stack(xs)
    return LSSIndex(
        theta=stack(*(s.theta for s in shards)),
        tables=LSSTables(stack(*(s.tables.table_ids for s in shards)),
                         stack(*(s.tables.n_dropped for s in shards)),
                         lss.k_bits, lss.n_tables, cfg.capacity),
        w_bucketed=stack(*(s.w_bucketed for s in shards)))


def lss_head(q: torch.Tensor, index_stack: LSSIndex, *, k: int,
             m_local: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The vocab-sharded LSS head of the decode and BERT4Rec serve cells:
    ``q`` [B, d] whole on every rank; each rank serves its shard of
    ``index_stack`` (the leading ``[tp]`` axis, split over ``model``)
    through ``core.sharded.sharded_lss_predict`` (the fused ``lss_topk``)
    and the top-k is merged over the ``model`` ranks -> (logits [B, k],
    global ids [B, k]), the same on every rank."""
    theta = index_stack.theta
    smesh = ServingMesh.local(1)
    if is_dtensor(theta):
        mesh = theta.device_mesh
        names = tuple(mesh.mesh_dim_names)
        tp = _axis(mesh, "model")
        if tp > 1:
            group = mesh.get_group(names.index("model"))
            smesh = ServingMesh(
                n_hosts=1, ranks_per_host=tp,
                rank=mesh.get_coordinate()[names.index("model")],
                backend=dist.get_backend(group), group=group,
                host_group=group)
    one = lambda t: to_local(t)[0]
    t = index_stack.tables
    idx = LSSIndex(one(theta), LSSTables(one(t.table_ids), one(t.n_dropped),
                                         t.k_bits, t.n_tables, t.capacity),
                   one(index_stack.w_bucketed))
    return sharded_lss_predict(q, [idx], None, k=k, mesh=smesh,
                               m_local=m_local)


def _lm_decode_cell(spec: ArchSpec, shape, mesh) -> Cell:
    cfg = spec.model_cfg
    gb, sl = shape.dims["global_batch"], shape.dims["seq_len"]
    tp = _axis(mesh, "model")
    m_local = -(-cfg.vocab // tp)
    lss = spec.lss
    d_aug = cfg.d_model + 1

    def fn(params, token, cache, index_stack):
        hidden, new_cache = T.decode_step(params, token, cache, cfg)
        # vocab-sharded LSS head (paper Algorithm 2, distributed)
        logits, ids = lss_head(full_tensor(hidden).float(), index_stack,
                               k=8, m_local=m_local)
        return logits, ids, new_cache

    params = _lm_params_meta(cfg)
    token = _meta((gb,), i32)
    kv = (cfg.n_layers, gb, sl, cfg.n_kv_heads, cfg.head_dim)
    cache = T.KVCache(k=_meta(kv, bf16), v=_meta(kv, bf16),
                      length=_meta((), i32))
    index = _lss_index_meta(lss, m_local, d_aug, tp)
    cache_spec = _specs(mesh, T.cache_specs(cfg, gb))
    sh = (_specs(mesh, T.param_specs(cfg)),
          _ns(mesh, P()),
          cache_spec,
          _sharded(mesh, index, lambda t: P("model")))
    # decode useful FLOPs: 2*N_active per token + KV attention 4*L*kv*h*S
    n_active = cfg.active_param_count() - cfg.vocab * cfg.d_model  # LSS head!
    attn = 2 * 2 * cfg.n_layers * cfg.n_heads * cfg.head_dim * sl
    cap = index.tables.capacity
    lss_flops = 2 * d_aug * (lss.k_bits * lss.n_tables + lss.n_tables * cap)
    mf = (2 * n_active + attn + lss_flops * tp) * gb

    def init(gen, device):
        params = T.init_params(gen, cfg, device=device)
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        k = torch.empty(kv, dtype=bf16, device=device)
        v = torch.empty(kv, dtype=bf16, device=device)
        for t in (k, v):
            for i in range(cfg.n_layers):        # a layer at a time
                t[i].copy_(_normal(gen, kv[1:], device, bf16))
        # the step attends over the whole context (what model_flops
        # counts): sl - 1 positions are filled, it writes the last one
        cache = T.KVCache(k, v, torch.tensor(sl - 1, dtype=i32,
                                             device=device))
        index = _lss_index_init(gen, augment_neurons(head.float()), lss, tp)
        return (params, _ints(gen, cfg.vocab, (gb,), device), cache, index)

    return Cell(spec.arch_id, shape.name, fn, (params, token, cache, index),
                sh, mf, "decode_step + vocab-sharded LSS head",
                init_args=init)


# ==================================================================== GNN ==

def _gnn_state_meta(cfg) -> TrainState:
    params = eval_shape(lambda: gnn.init_params(torch.Generator(), cfg,
                                                device="cpu"))
    return _state_meta(params, f32)


def _gnn_state_init(gen, cfg, device) -> TrainState:
    return _fresh_state(gnn.init_params(gen, cfg, device=device), f32)


def _edges(gen, n: int, e: int, e_pad: int, device, lead=()):
    edges = _ints(gen, n, lead + (e_pad, 2), device)
    edges[..., e:, :] = -1
    return edges


def _gnn_train_cell(spec: ArchSpec, shape, mesh) -> Cell:
    dims = shape.dims
    cfg = spec.model_cfg._replace(d_feat=dims["d_feat"],
                                  n_classes=dims["n_classes"])
    tc = TrainConfig()
    loss_fn = functools.partial(_gnn_loss_fn, cfg=cfg)
    step = make_train_step(loss_fn, tc, donate=True)
    state = _gnn_state_meta(cfg)
    dp = _axis(mesh, "data")
    n_pad = _pad_up(dims["n_nodes"], dp)
    e_pad = _pad_up(dims["n_edges"], dp)
    batch = {
        "x": _meta((n_pad, dims["d_feat"]), f32),
        "edges": _meta((e_pad, 2), i32),
        "labels": _meta((n_pad,), i32),
    }
    sh_state = _state_sh(mesh, gnn.param_specs(cfg))
    sh_batch = _data_spec(mesh, batch)
    e, n = dims["n_edges"], dims["n_nodes"]
    d0, dh, c = dims["d_feat"], cfg.d_hidden, dims["n_classes"]
    mf = 3 * (2 * n * (d0 * dh + dh * c) + 2 * e * (d0 + dh))

    def init(gen, device):
        x = _normal(gen, (n_pad, d0), device)
        x[n:] = 0
        labels = _ints(gen, c, (n_pad,), device)
        labels[n:] = -1
        return (_gnn_state_init(gen, cfg, device),
                {"x": x, "edges": _edges(gen, n, e, e_pad, device),
                 "labels": labels})

    return Cell(spec.arch_id, shape.name, step, (state, batch),
                (sh_state, sh_batch), mf, "full-batch GCN train_step",
                donate_state=True, init_args=init)


def _gnn_loss_fn(params, batch, cfg):
    return gnn.loss(params, batch, cfg)


def _gnn_minibatch_cell(spec: ArchSpec, shape, mesh) -> Cell:
    dims = shape.dims
    cfg = spec.model_cfg._replace(d_feat=dims["d_feat"],
                                  n_classes=dims["n_classes"])
    fanout = dims["fanout"]
    bn = dims["batch_nodes"]
    tc = TrainConfig()

    def loss_fn(params, batch):
        params, batch = gnn.gathered(params, batch)
        nodes, edges = gnn.sampled_subgraph(
            gnn.seeded_generator(batch["seed"]), batch["indptr"],
            batch["indices"], batch["seeds"], fanout)
        x = batch["x"][nodes]
        labels = torch.full((nodes.shape[0],), -1, dtype=i32,
                            device=x.device)
        labels[:bn] = batch["seed_labels"]
        return gnn.loss(params, {"x": x, "edges": edges, "labels": labels},
                        cfg)

    step = make_train_step(loss_fn, tc, donate=True)
    state = _gnn_state_meta(cfg)
    both = _axis(mesh, "data") * _axis(mesh, "model")
    n, e = dims["n_nodes"], dims["n_edges"]
    batch = {
        "seed": _meta((), torch.int64),
        "indptr": _meta((n + 1,), i32),
        "indices": _meta((_pad_up(e, both),), i32),
        "seeds": _meta((bn,), i32),
        "seed_labels": _meta((bn,), i32),
        "x": _meta((_pad_up(n, both), dims["d_feat"]), f32),
    }
    sh_state = _state_sh(mesh, gnn.param_specs(cfg))
    sh_batch = None if mesh is None else {
        "seed": _ns(mesh, P()),
        "indptr": _ns(mesh, P()),
        "indices": _ns(mesh, P(("data", "model"))),
        "seeds": _ns(mesh, P("data")),
        "seed_labels": _ns(mesh, P("data")),
        "x": _ns(mesh, P(("data", "model"), None)),
    }
    blk = bn * (1 + fanout[0] + fanout[0] * fanout[1])
    mf = 3 * 2 * blk * (dims["d_feat"] * cfg.d_hidden
                        + cfg.d_hidden * dims["n_classes"])

    def init(gen, device):
        e_pad = batch["indices"].shape[0]
        return (_gnn_state_init(gen, cfg, device), {
            "seed": torch.zeros((), dtype=torch.int64, device=device),
            # a CSR of uniform degree over n nodes
            "indptr": (torch.arange(n + 1, device=device, dtype=torch.int64)
                       * e // n).to(i32),
            "indices": _ints(gen, n, (e_pad,), device),
            "seeds": _ints(gen, n, (bn,), device),
            "seed_labels": _ints(gen, dims["n_classes"], (bn,), device),
            "x": _normal(gen, batch["x"].shape, device)})

    return Cell(spec.arch_id, shape.name, step, (state, batch),
                (sh_state, sh_batch), mf,
                "fanout-sampled GCN train_step (sampler in-graph)",
                donate_state=True, init_args=init)


def _gnn_molecule_cell(spec: ArchSpec, shape, mesh) -> Cell:
    dims = shape.dims
    cfg = spec.model_cfg._replace(d_feat=dims["d_feat"],
                                  n_classes=dims["n_classes"],
                                  readout="mean")
    tc = TrainConfig()
    loss_fn = functools.partial(_mol_loss_fn, cfg=cfg)
    step = make_train_step(loss_fn, tc, donate=True)
    state = _gnn_state_meta(cfg)
    g, n, e = dims["batch"], dims["n_nodes"], dims["n_edges"]
    batch = {
        "x": _meta((g, n, dims["d_feat"]), f32),
        "edges": _meta((g, e, 2), i32),
        "labels": _meta((g,), i32),
    }
    sh_state = _state_sh(mesh, gnn.param_specs(cfg))
    sh_batch = _data_spec(mesh, batch)
    mf = 3 * 2 * g * n * (dims["d_feat"] * cfg.d_hidden
                          + cfg.d_hidden * dims["n_classes"])

    def init(gen, device):
        return (_gnn_state_init(gen, cfg, device), {
            "x": _normal(gen, (g, n, dims["d_feat"]), device),
            "edges": _ints(gen, n, (g, e, 2), device),
            "labels": _ints(gen, dims["n_classes"], (g,), device)})

    return Cell(spec.arch_id, shape.name, step, (state, batch),
                (sh_state, sh_batch), mf, "batched small-graph train_step",
                donate_state=True, init_args=init)


def _mol_loss_fn(params, batch, cfg):
    return gnn.molecule_loss(params, batch, cfg)


# ================================================================= RecSys ==

def ctr_logits(params, batch, cfg):
    if cfg.kind == "deepfm":
        return recsys.deepfm_logits(params, batch["ids"], cfg)
    if cfg.kind == "autoint":
        return recsys.autoint_logits(params, batch["ids"], cfg)
    if cfg.kind == "dien":
        return recsys.dien_logits(
            params, {"hist": batch["hist"], "target": batch["target"]}, cfg)
    raise ValueError(cfg.kind)


def ctr_loss(params, batch, cfg):
    """The CTR train cells' logistic loss (the JAX module's
    ``_ctr_loss``)."""
    lg = ctr_logits(params, batch, cfg)
    y = batch["labels"].float()
    return torch.mean(lg.clamp(min=0) - lg * y
                      + torch.log1p(torch.exp(-lg.abs())))


def _ctr_init(cfg):
    if cfg.kind == "deepfm":
        return recsys.init_deepfm, recsys.deepfm_specs
    if cfg.kind == "autoint":
        return recsys.init_autoint, recsys.autoint_specs
    return recsys.init_dien, recsys.dien_specs


def _ctr_batch_meta(cfg, b):
    if cfg.kind == "dien":
        return {"hist": _meta((b, cfg.seq_len), i32),
                "target": _meta((b,), i32), "labels": _meta((b,), i32)}
    return {"ids": _meta((b, cfg.n_fields), i32), "labels": _meta((b,), i32)}


def _ctr_batch_init(gen, cfg, b, device):
    v = cfg.vocab_per_field
    if cfg.kind == "dien":
        hist = _ints(gen, v, (b, cfg.seq_len), device)
        # a padded tail of random length (at least one item)
        keep = _ints(gen, cfg.seq_len + 1, (b, 1), device, low=1)
        pos = torch.arange(cfg.seq_len, device=device)[None]
        return {"hist": torch.where(pos < keep, hist, -1),
                "target": _ints(gen, v, (b,), device),
                "labels": _ints(gen, 2, (b,), device)}
    return {"ids": _ints(gen, v, (b, cfg.n_fields), device),
            "labels": _ints(gen, 2, (b,), device)}


def _ctr_flops(cfg, b):
    d = cfg.embed_dim
    if cfg.kind == "deepfm":
        dims = [cfg.n_fields * d, *cfg.mlp_dims, 1]
        mlp = sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        return b * (mlp + 2 * cfg.n_fields * d)
    if cfg.kind == "autoint":
        da = cfg.d_attn * cfg.n_heads
        f = cfg.n_fields
        per_layer = 2 * f * (4 * d * da) + 4 * f * f * da
        return b * cfg.n_attn_layers * per_layer
    g = cfg.gru_dim
    per_t = 2 * (d * 3 * g + g * 3 * g) * 2       # gru1 + augru
    dims = [g + 2 * d, *cfg.mlp_dims, 1]
    mlp = sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    return b * (cfg.seq_len * per_t + mlp)


def _ctr_params_meta(init_fn, cfg):
    return eval_shape(lambda: init_fn(torch.Generator(), cfg, device="cpu"))


def _ctr_train_cell(spec: ArchSpec, shape, mesh) -> Cell:
    cfg = spec.model_cfg._replace(unroll_scan=True)
    b = shape.dims["batch"]
    init_fn, specs_fn = _ctr_init(cfg)
    tc = TrainConfig()
    loss_fn = functools.partial(ctr_loss, cfg=cfg)
    step = make_train_step(loss_fn, tc, donate=True)
    state = _state_meta(_ctr_params_meta(init_fn, cfg), f32)
    batch = _ctr_batch_meta(cfg, b)
    sh_state = _state_sh(mesh, specs_fn(cfg))
    sh_batch = _data_spec(mesh, batch)

    def init(gen, device):
        return (_fresh_state(init_fn(gen, cfg, device=device), f32),
                _ctr_batch_init(gen, cfg, b, device))

    return Cell(spec.arch_id, shape.name, step, (state, batch),
                (sh_state, sh_batch), 3 * _ctr_flops(cfg, b),
                "CTR train_step (BCE)", donate_state=True, init_args=init)


def _ctr_serve_cell(spec: ArchSpec, shape, mesh) -> Cell:
    cfg = spec.model_cfg._replace(unroll_scan=True)
    b = shape.dims["batch"]
    init_fn, specs_fn = _ctr_init(cfg)

    def fn(params, batch):
        return torch.sigmoid(ctr_logits(params, batch, cfg))

    params = _ctr_params_meta(init_fn, cfg)
    batch = _ctr_batch_meta(cfg, b)
    batch.pop("labels")
    sh = (_specs(mesh, specs_fn(cfg)), _data_spec(mesh, batch))

    def init(gen, device):
        params = init_fn(gen, cfg, device=device)
        batch = _ctr_batch_init(gen, cfg, b, device)
        batch.pop("labels")
        return params, batch

    return Cell(spec.arch_id, shape.name, fn, (params, batch), sh,
                _ctr_flops(cfg, b), "CTR serve_step", init_args=init)


def _ctr_retrieval_cell(spec: ArchSpec, shape, mesh) -> Cell:
    cfg = spec.model_cfg._replace(unroll_scan=True)
    c = shape.dims["n_candidates"]
    init_fn, specs_fn = _ctr_init(cfg)

    if cfg.kind == "dien":
        def fn(params, hist, cand):
            hist_b = hist.expand(c, hist.shape[1])
            return torch.sigmoid(recsys.dien_logits(
                params, {"hist": hist_b, "target": cand}, cfg))
        user = _meta((1, cfg.seq_len), i32)
    else:
        def fn(params, user, cand):
            ids = torch.cat([cand[:, None],
                             user[:, 1:].expand(c, cfg.n_fields - 1)], 1)
            return torch.sigmoid(ctr_logits(params, {"ids": ids}, cfg))
        user = _meta((1, cfg.n_fields), i32)

    params = _ctr_params_meta(init_fn, cfg)
    cand = _meta((c,), i32)     # 1e6 % 16 == 0: split over data only
    sh = (_specs(mesh, specs_fn(cfg)),
          _ns(mesh, P()),
          _ns(mesh, P("data")))

    def init(gen, device):
        return (init_fn(gen, cfg, device=device),
                _ints(gen, cfg.vocab_per_field, tuple(user.shape), device),
                _ints(gen, cfg.vocab_per_field, (c,), device))

    return Cell(spec.arch_id, shape.name, fn, (params, user, cand), sh,
                _ctr_flops(cfg, c), "1 query x 1M candidate scoring",
                init_args=init)


# BERT4Rec --------------------------------------------------------------

N_MASK = 20        # masked positions per sequence (cloze)
N_NEG = 8192       # sampled-softmax negatives (training only)


def b4r_sampled_loss(params, batch, cfg):
    """Cloze with sampled softmax (the JAX module's ``_b4r_sampled_loss``):
    full 1M softmax at train time is the exact cost LSS removes at serve
    time; sampled softmax is the standard training-side treatment
    (uniform negatives here)."""
    hidden = recsys.bert4rec_encode(params, batch["seq"], cfg)
    pos = batch["mask_pos"].long()
    hsel = hidden.gather(1, pos[..., None].expand(*pos.shape,
                                                  hidden.shape[-1]))
    pos_rows = recsys.embedding_lookup(params["head"],
                                       batch["mask_labels"])    # [B, M, D]
    neg_rows = recsys.embedding_lookup(params["head"],
                                       batch["neg_ids"])        # [Nneg, D]
    pos_logit = torch.einsum("bmd,bmd->bm", hsel, pos_rows).float()
    neg_logit = torch.einsum("bmd,nd->bmn", hsel, neg_rows).float()
    logz = torch.logaddexp(pos_logit, torch.logsumexp(neg_logit, -1))
    return torch.mean(logz - pos_logit)


def _b4r_enc_flops(cfg):
    d = cfg.embed_dim
    return cfg.n_blocks * (8 * d * d + 4 * cfg.seq_len * d) * cfg.seq_len * 2


def _b4r_params_meta(cfg):
    return eval_shape(lambda: recsys.init_bert4rec(torch.Generator(), cfg,
                                                   device="cpu"))


def _b4r_train_cell(spec: ArchSpec, shape, mesh) -> Cell:
    cfg = spec.model_cfg
    b = shape.dims["batch"]
    tc = TrainConfig()
    loss_fn = functools.partial(b4r_sampled_loss, cfg=cfg)
    step = make_train_step(loss_fn, tc, donate=True)
    state = _state_meta(_b4r_params_meta(cfg), f32)
    batch = {
        "seq": _meta((b, cfg.seq_len), i32),
        "mask_pos": _meta((b, N_MASK), i32),
        "mask_labels": _meta((b, N_MASK), i32),
        "neg_ids": _meta((N_NEG,), i32),
    }
    sh_state = _state_sh(mesh, recsys.bert4rec_specs(cfg))
    sh_batch = _data_spec(mesh, batch)
    if sh_batch is not None:
        sh_batch["neg_ids"] = _ns(mesh, P())
    d = cfg.embed_dim
    head = 2 * N_MASK * (N_NEG + 1) * d

    def init(gen, device):
        return (_fresh_state(recsys.init_bert4rec(gen, cfg, device=device),
                             f32), {
            "seq": _ints(gen, cfg.n_items, (b, cfg.seq_len), device),
            "mask_pos": _ints(gen, cfg.seq_len, (b, N_MASK), device),
            "mask_labels": _ints(gen, cfg.n_items, (b, N_MASK), device),
            "neg_ids": _ints(gen, cfg.n_items, (N_NEG,), device)})

    return Cell(spec.arch_id, shape.name, step, (state, batch),
                (sh_state, sh_batch), 3 * b * (_b4r_enc_flops(cfg) + head),
                "cloze train_step (sampled softmax)", donate_state=True,
                init_args=init)


def _b4r_serve_cell(spec: ArchSpec, shape, mesh) -> Cell:
    """Encode + vocab-sharded LSS top-k over the 1M-item WOL."""
    cfg = spec.model_cfg
    b = shape.dims.get("batch", 1)
    tp = _axis(mesh, "model")
    m_local = -(-cfg.n_items // tp)
    lss = spec.lss
    d_aug = cfg.embed_dim + 1

    def fn(params, seq, index_stack):
        hidden = recsys.bert4rec_encode(params, seq, cfg)
        q = full_tensor(hidden[:, -1]).float()
        return lss_head(q, index_stack, k=10, m_local=m_local)

    params = _b4r_params_meta(cfg)
    seq = _meta((b, cfg.seq_len), i32)
    index = _lss_index_meta(lss, m_local, d_aug, tp)
    # the encoder is replicated, so its batch can split over BOTH axes;
    # only the [B, 64] queries are gathered for the head
    nd = _axis(mesh, "data") * tp
    seq_spec = (P(("data", "model"), None) if b % nd == 0
                else P("data", None) if b % _axis(mesh, "data") == 0
                else P())
    sh = (_specs(mesh, recsys.bert4rec_specs(cfg)),
          NamedSharding(mesh, seq_spec),
          _sharded(mesh, index, lambda t: P("model")))
    cap = index.tables.capacity
    lss_fl = 2 * d_aug * (lss.k_bits + cap) * tp

    def init(gen, device):
        params = recsys.init_bert4rec(gen, cfg, device=device)
        index = _lss_index_init(gen, augment_neurons(params["head"].float()),
                                lss, tp)
        return (params, _ints(gen, cfg.n_items, (b, cfg.seq_len), device),
                index)

    return Cell(spec.arch_id, shape.name, fn, (params, seq, index), sh,
                b * (_b4r_enc_flops(cfg) + lss_fl),
                "encode + sharded LSS item retrieval", init_args=init)


def _b4r_retrieval_cell(spec: ArchSpec, shape, mesh) -> Cell:
    # retrieval_cand: batch=1 against the full 1M catalogue — the serve
    # pipeline at batch 1 (the paper's Table-1 setting)
    return _b4r_serve_cell(spec, shape, mesh)


# =============================================================== dispatch ==

def build_cell(arch_id: str, shape_name: str, mesh, *,
               lm_layers: int | None = None, dims: dict | None = None
               ) -> Cell:
    """The cell of ``(arch_id, shape_name)`` on ``mesh`` (a ``DeviceMesh``
    with dims named ``data``, ``model`` and, on two pods, ``pod``; None:
    one device, no shardings).

    ``lm_layers`` cuts an LM's depth; ``dims`` overrides entries of the
    shape's dims (a cut of its batch, say).  The dry-run
    traces every layer and every attention chunk of a full-depth LM, so
    it needs no cut; the JAX module's ``lm_impl`` has no counterpart."""
    spec = get_config(arch_id)
    shape = spec.shape(shape_name)
    if dims:
        shape = shape._replace(dims={**shape.dims, **dims})
    if spec.family == "lm":
        # grouped dispatch pays off on big token batches (train/prefill);
        # at decode (<= 128 tokens a step) one group
        groups = _axis(mesh, "data") if shape.kind in ("train", "prefill") \
            else 1
        mc = spec.model_cfg._replace(
            n_layers=lm_layers or spec.model_cfg.n_layers,
            moe_groups=groups)
        spec = spec._replace(model_cfg=mc)
        if shape.kind == "train":
            return _lm_train_cell(spec, shape, mesh)
        if shape.kind == "prefill":
            return _lm_prefill_cell(spec, shape, mesh)
        return _lm_decode_cell(spec, shape, mesh)
    if spec.family == "gnn":
        if shape.kind == "train_sampled":
            return _gnn_minibatch_cell(spec, shape, mesh)
        if shape.kind == "train_batched":
            return _gnn_molecule_cell(spec, shape, mesh)
        return _gnn_train_cell(spec, shape, mesh)
    if spec.family == "recsys_ctr":
        if shape.kind == "train":
            return _ctr_train_cell(spec, shape, mesh)
        if shape.kind == "retrieval":
            return _ctr_retrieval_cell(spec, shape, mesh)
        return _ctr_serve_cell(spec, shape, mesh)
    if spec.family == "recsys_seq":
        if shape.kind == "train":
            return _b4r_train_cell(spec, shape, mesh)
        if shape.kind == "retrieval":
            return _b4r_retrieval_cell(spec, shape, mesh)
        return _b4r_serve_cell(spec, shape, mesh)
    raise ValueError(spec.family)
