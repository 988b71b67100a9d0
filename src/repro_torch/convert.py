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
from repro_torch.models.xc import XCConfig, XCModel
from repro_torch.optim.adamw import AdamWState

__all__ = ["tensor_from_numpy", "xc_params_from_numpy",
           "lss_index_from_numpy", "adamw_state_from_numpy"]


def tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    """numpy (or array-like) -> a tensor of its own (a copy) on ``device``;
    bfloat16 arrays (numpy dtype name ``bfloat16``) keep their bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def xc_params_from_numpy(params: dict, device: str | torch.device | None = None
                         ) -> XCModel:
    """An :class:`XCModel` holding the JAX ``xc.init_params`` dict
    (``embed``, ``w_out``, ``b_out``), sized from the arrays."""
    dev = resolve_device(device)
    embed = tensor_from_numpy(params["embed"], dev)
    w_out = tensor_from_numpy(params["w_out"], dev)
    b_out = tensor_from_numpy(params["b_out"], dev)
    cfg = XCConfig("converted", input_dim=embed.shape[0],
                   hidden=embed.shape[1], output_dim=w_out.shape[0],
                   dtype=embed.dtype)
    model = XCModel(cfg, torch.Generator(), device="cpu").to(dev)
    with torch.no_grad():
        model.embed_table.copy_(embed)
        model.w_out.copy_(w_out)
        model.b_out.copy_(b_out)
    return model


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


def adamw_state_from_numpy(step, mu, nu,
                           device: str | torch.device | None = None
                           ) -> AdamWState:
    """An :class:`AdamWState` from the fields of a JAX ``AdamWState``
    (``mu`` and ``nu`` an array or a nested dict of arrays), so that the
    port can resume from JAX's Adam moments."""
    dev = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return tensor_from_numpy(tree, dev)
    return AdamWState(tensor_from_numpy(step, dev).to(torch.int32),
                      conv(mu), conv(nu))
