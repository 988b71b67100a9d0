"""Carry weights across from the JAX package, as numpy arrays.

The two frameworks draw different numbers from the same seed, so parity
tests build the model and the index in JAX, hand the arrays over as
numpy, and compare the port's outputs on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lss import LSSIndex
from repro_torch.core.tables import LSSTables
from repro_torch.device import resolve_device
from repro_torch.models.transformer import TransformerConfig
from repro_torch.models.xc import XCModel
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.trainer import TrainState, state_shardings
from repro_torch.utils.tree import tree_map

__all__ = ["tensor_from_numpy", "xc_params_from_numpy",
           "lstm_params_from_numpy", "transformer_params_from_numpy",
           "lss_index_from_numpy", "lss_index_stack_from_numpy",
           "adamw_state_from_numpy", "train_state_from_numpy",
           "sharded_train_state_from_numpy"]

# JAX's XC parameter names -> the port's (the rest are the same)
_XC_NAMES = {"embed": "embed_table"}


def tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    """numpy (or array-like) -> a tensor of its own (a copy) on ``device``;
    bfloat16 arrays (numpy dtype name ``bfloat16``) keep their bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _params(tree, dev: torch.device):
    """A (nested) dict of arrays -> tensors on ``dev``, JAX's XC names
    mapped to the port's."""
    if isinstance(tree, dict):
        return {_XC_NAMES.get(k, k): _params(v, dev) for k, v in tree.items()}
    return tensor_from_numpy(tree, dev)


def xc_params_from_numpy(params: dict, device: str | torch.device | None = None
                         ) -> XCModel:
    """An :class:`XCModel` holding the JAX ``xc.init_params`` dict
    (``embed``, ``w_out``, ``b_out``), sized from the arrays."""
    return XCModel.from_params(_params(params, resolve_device(device)))


def lstm_params_from_numpy(params: dict,
                           device: str | torch.device | None = None
                           ) -> dict:
    """The JAX ``lstm.init_params`` dict (``embed``, ``layers``: ``wx``,
    ``wh``, ``b``; ``w_out``, ``b_out``) as the port's: the same names and
    nesting, each array a tensor on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), params)


def transformer_params_from_numpy(params: dict, cfg: TransformerConfig,
                                  device: str | torch.device | None = None
                                  ) -> dict:
    """The JAX ``transformer.init_params`` tree (``embed``, ``layers`` with
    stacked ``[n_layers, ...]`` leaves, ``final_norm``, ``lm_head`` when
    untied; for the MoE styles ``layers.moe.{router,w_gate,w_up,w_down}``
    and the shared expert's ``sh_*``) as the port's: the same names,
    nesting and dtypes (bf16 by its bits), each array a tensor on
    ``device``.  The embedding and every MoE leaf are checked against
    ``cfg``'s shapes."""
    want = (cfg.vocab, cfg.d_model)
    if tuple(np.shape(params["embed"])) != want:
        raise ValueError(f"embed {np.shape(params['embed'])} != {want} of "
                         f"{cfg.name}")
    if ("lm_head" in params) == cfg.tie_embeddings:
        raise ValueError(f"{cfg.name}: lm_head must be present iff the "
                         f"embeddings are untied")
    lyr = params["layers"]
    if ("moe" in lyr) != (cfg.moe_style != "none"):
        raise ValueError(f"{cfg.name}: layers.moe must be present iff "
                         f"moe_style != 'none' (it is {cfg.moe_style!r})")
    n, d = cfg.n_layers, cfg.d_model
    shapes = {}
    if cfg.moe_style != "none":
        ep, f = cfg.n_experts_padded, cfg.moe_d_ff
        shapes.update({("moe", "router"): (n, d, ep),
                       ("moe", "w_gate"): (n, ep, d, f),
                       ("moe", "w_up"): (n, ep, d, f),
                       ("moe", "w_down"): (n, ep, f, d)})
    if cfg.shared_expert_ff:
        sf = cfg.shared_expert_ff
        shapes.update({("sh_gate",): (n, d, sf), ("sh_up",): (n, d, sf),
                       ("sh_down",): (n, sf, d), ("sh_gate_w",): (n, d, 1)})
    for path, shape in shapes.items():
        node = lyr
        for key in path:
            if key not in node:
                raise ValueError(f"{cfg.name}: layers.{'.'.join(path)} is "
                                 f"missing")
            node = node[key]
        if tuple(np.shape(node)) != shape:
            raise ValueError(f"{cfg.name}: layers.{'.'.join(path)} "
                             f"{np.shape(node)} != {shape}")
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), params)


def lss_index_from_numpy(theta, table_ids, n_dropped, w_bucketed, w_scale,
                         k_bits: int, n_tables: int, capacity: int,
                         device: str | torch.device | None = None
                         ) -> LSSIndex:
    """An :class:`LSSIndex` from the fields of a JAX ``LSSIndex``
    (``w_bucketed`` and ``w_scale`` may be None)."""
    dev = resolve_device(device)
    tables = LSSTables(tensor_from_numpy(table_ids, dev),
                       tensor_from_numpy(n_dropped, dev), k_bits, n_tables,
                       capacity)
    return LSSIndex(
        tensor_from_numpy(theta, dev), tables,
        None if w_bucketed is None else tensor_from_numpy(w_bucketed, dev),
        None if w_scale is None else tensor_from_numpy(w_scale, dev))


def lss_index_stack_from_numpy(theta, table_ids, n_dropped, w_bucketed,
                               w_scale, k_bits: int, n_tables: int,
                               capacity: int,
                               device: str | torch.device | None = None
                               ) -> list[LSSIndex]:
    """The port's per-shard indexes (``serve.heads.shard_index``'s list)
    from the fields of a stacked JAX ``shard_index`` result: every leaf
    carries a leading ``[n_shards]`` axis (``w_bucketed`` and ``w_scale``
    may be None)."""
    def shard(a, i):
        return None if a is None else np.asarray(a)[i]

    return [lss_index_from_numpy(shard(theta, i), shard(table_ids, i),
                                 shard(n_dropped, i), shard(w_bucketed, i),
                                 shard(w_scale, i), k_bits, n_tables,
                                 capacity, device=device)
            for i in range(np.shape(table_ids)[0])]


def adamw_state_from_numpy(step, mu, nu,
                           device: str | torch.device | None = None
                           ) -> AdamWState:
    """An :class:`AdamWState` from the fields of a JAX ``AdamWState``
    (``mu`` and ``nu`` an array or a nested dict of arrays), so that the
    port can resume from JAX's Adam moments."""
    dev = resolve_device(device)
    return AdamWState(tensor_from_numpy(step, dev).to(torch.int32),
                      _params(mu, dev), _params(nu, dev))


def train_state_from_numpy(params, opt, step,
                           device: str | torch.device | None = None
                           ) -> TrainState:
    """A :class:`TrainState` from the fields of a JAX ``TrainState``:
    ``params`` (an array or a nested dict), ``opt`` the ``(step, mu, nu)``
    of its ``AdamWState``, and ``step``; JAX's ``embed`` becomes
    ``embed_table``."""
    dev = resolve_device(device)
    return TrainState(_params(params, dev),
                      adamw_state_from_numpy(*opt, device=dev),
                      tensor_from_numpy(step, dev).to(torch.int32))


def sharded_train_state_from_numpy(params, opt, step, mesh, param_specs
                                   ) -> TrainState:
    """A :class:`TrainState` from numpy fields (``params`` a nested dict
    under the port's names, ``opt`` the ``(step, mu, nu)`` of an
    ``AdamWState``, ``step``) laid out on ``mesh`` by ``param_specs``, as
    ``trainer.state_shardings`` lays a state out (the moments as the
    parameters, the step replicated): every rank passes the whole arrays
    and keeps its own pieces."""
    cpu = torch.device("cpu")

    def tensors(tree):
        return tree_map(lambda a: tensor_from_numpy(a, cpu), tree)

    state = TrainState(tensors(params), AdamWState(
        tensor_from_numpy(opt[0], cpu).to(torch.int32), tensors(opt[1]),
        tensors(opt[2])), tensor_from_numpy(step, cpu).to(torch.int32))
    return tree_map(lambda t, sh: sh.place(t), state,
                    state_shardings(mesh, param_specs))
