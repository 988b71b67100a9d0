"""AdamW and gradient clipping (counterpart of ``repro.optim.adamw``),
written as plain functions on a tensor or a tree of tensors
(:mod:`repro_torch.utils.tree`: JAX's leaf order).

The update is the JAX package's formula: fp32 moments, bias correction in
fp32, and ``p - lr * (update + weight_decay * p)``.  It returns new
tensors and leaves its arguments as they were, as the JAX version does.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.utils.tree import (tree_flatten, tree_leaves, tree_map,
                                    tree_unflatten)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm"]


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 []
    mu: Any              # like params
    nu: Any              # like params


def adamw_init(params: Any, dtype: torch.dtype = torch.float32) -> AdamWState:
    device = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """Returns (clipped grads, pre-clip global norm)."""
    sq = sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads))
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


def adamw_update(grads: Any, state: AdamWState, params: Any, *,
                 lr: float | torch.Tensor, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 ) -> tuple[Any, AdamWState]:
    """One AdamW step; ``lr`` may be a tensor (a schedule's output)."""
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def upd(p, g, mu, nu):
        g32 = g.float()
        mu = b1 * mu + (1.0 - b1) * g32
        nu = b2 * nu + (1.0 - b2) * torch.square(g32)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        p32 = p.float()
        new_p = p32 - lr * (update + weight_decay * p32)
        return new_p.to(p.dtype), mu, nu

    flat_p, treedef = tree_flatten(params)
    out = [upd(*xs) for xs in zip(flat_p, *(tree_leaves(t) for t in
                                            (grads, state.mu, state.nu)))]
    pick = lambda i: tree_unflatten(treedef, [o[i] for o in out])
    return pick(0), AdamWState(step, pick(1), pick(2))
