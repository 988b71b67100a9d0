"""AdamW and gradient clipping (counterpart of ``repro.optim.adamw``),
written as plain functions on a tensor or a tree of tensors
(:mod:`repro_torch.utils.tree`: JAX's leaf order).

The update is the JAX package's formula: fp32 moments, bias correction in
fp32, and ``p - lr * (update + weight_decay * p)``.  It returns new
tensors and leaves its arguments as they were, as the JAX version does,
unless ``inplace`` asks it to write them into the old ones (the
trainer's donation).

Sharded leaves (``DTensor``, each gradient and moment laid out as its
parameter) are updated piece by piece on each rank
(:func:`~repro_torch.utils.sharding.map_local`): the update is
elementwise, so it needs no collective.  The global norm sums each
leaf's squares, reduced over the mesh dims that split it (one scalar
all-reduce a sharded leaf), in leaf order.  The step counter and the
learning rate stay plain 0-d tensors: every rank holds the same value.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.utils.sharding import map_local, replicate, to_local
from repro_torch.utils.tree import (tree_flatten, tree_leaves, tree_map,
                                    tree_unflatten)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm"]


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 []
    mu: Any              # like params
    nu: Any              # like params


def adamw_init(params: Any, dtype: torch.dtype = torch.float32) -> AdamWState:
    device = to_local(tree_leaves(params)[0]).device
    zeros = lambda p: torch.zeros_like(p, dtype=dtype,
                                       memory_format=torch.contiguous_format)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """Returns (clipped grads, pre-clip global norm); the norm is a plain
    0-d tensor, sharded leaves or not."""
    sq = sum(to_local(replicate(torch.sum(torch.square(g.float()))))
             for g in tree_leaves(grads))
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: map_local(lambda x: (x * scale).to(x.dtype), g),
                    grads), norm


def adamw_update(grads: Any, state: AdamWState, params: Any, *,
                 lr: float | torch.Tensor, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 inplace: bool = False) -> tuple[Any, AdamWState]:
    """One AdamW step; ``lr`` may be a tensor (a schedule's output).  With
    ``inplace`` the new parameters and moments are written into the
    tensors of ``params`` and ``state`` (which are returned): a step then
    holds one copy of them, not two."""
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def upd(p, g, mu, nu):
        g32 = g.float()
        new_mu = b1 * mu + (1.0 - b1) * g32
        new_nu = b2 * nu + (1.0 - b2) * torch.square(g32)
        update = (new_mu / bc1) / (torch.sqrt(new_nu / bc2) + eps)
        p32 = p.float()
        new_p = (p32 - lr * (update + weight_decay * p32)).to(p.dtype)
        if inplace:
            return p.copy_(new_p), mu.copy_(new_mu), nu.copy_(new_nu)
        return new_p, new_mu, new_nu

    def leaf(p, g, mu, nu):
        out = map_local(upd, p, g, mu, nu)
        return (p, mu, nu) if inplace else out

    flat_p, treedef = tree_flatten(params)
    out = [leaf(*xs) for xs in zip(flat_p, *(tree_leaves(t) for t in
                                             (grads, state.mu, state.nu)))]
    pick = lambda i: tree_unflatten(treedef, [o[i] for o in out])
    return pick(0), AdamWState(step, pick(1), pick(2))
