"""Mixture-of-Experts layer: top-k routing + argsort dispatch (counterpart
of ``repro.models.moe``).

Dispatch is sort-based (a scatter into per-expert buffers, a gather
back), as in the JAX package.  Static shapes throughout: per-expert
capacity C = max(8, int(capacity_factor * Tg * top_k / E)) per dispatch
group; overflow tokens are dropped (their combine weight is 0), underflow
slots are zero-padded.  Nothing here synchronises with the host (no
``.item()``, ``nonzero`` or boolean indexing), so a decode step over it
is captured as a CUDA graph.

Every padded expert runs over the whole ``[G, E, C, D]`` buffer, as in
the JAX package: the expert products are plain batched products
(``torch.einsum``), which the JAX package leaves to XLA too.  At decode
that reads every expert's weights each step; a gather of the routed
experts only is later work (ROADMAP Queue 2).

Supports the two MoE archs:
  * qwen2-moe: 60 routed (padded to 64) top-4, renormalised probs, + 1
    shared expert with a sigmoid gate (``models.transformer``);
  * arctic: 128 routed top-2 + a DENSE residual MLP in parallel.

The JAX package's group path (``n_groups`` > 1, a ``vmap`` over groups)
and its one-group path compute the same function; here both run as one
batched code path over a leading group axis (one group: ``G = 1``).

On a mesh (``x`` a ``DTensor``; the trainer's (data, model) mesh), the
layer runs as GSPMD partitions the JAX one, in local pieces:

* tokens: each data shard dispatches its own tokens where the groups
  split evenly over the data shards (``n_groups`` a multiple of their
  number, the train and prefill cells' groups = data shards), so the
  router, the sort, ``searchsorted`` and the scatter into the trash row
  are local; otherwise (one group, the decode cells) the tokens are
  gathered whole on every rank first.  Every model rank routes the same
  tokens.
* experts: split over ``model``; a rank runs its own experts' SwiGLU over
  their capacity buffers and combines only the slots routed to them, so
  its output is a partial sum, reduced over ``model`` by one all-reduce
  of the tokens' activations.  With ``moe_fsdp`` (arctic) the expert
  tensors' d_ff is split over ``data`` too and gathered whole over
  ``data`` before use (its gradient is reduced back).
* the balance loss: the means over all tokens, each an all-reduce of an
  [Ep] vector.

So one step's collectives are the all-reduce of the output (and of its
gradient's partial sums), the [Ep] all-reduces of the balance loss, the
gathers of the tokens (one-group path) and of the FSDP expert tensors,
and the gradients' reductions over ``data``.  ``DTensor`` has no
sharding rule for argsort or ``searchsorted``; none of them sees a
``DTensor``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.topk import topk_lowest_index
from repro_torch.device import resolve_device
from repro_torch.utils.sharding import (P, is_dtensor, maybe_shard, replicate,
                                        shard_range)

__all__ = ["MoEConfig", "router_topk", "dispatch_indices", "moe_ffn",
           "moe_ffn_dense_oracle", "init_moe_params"]


class MoEConfig(NamedTuple):
    n_experts: int           # routed experts (logical, pre-padding)
    top_k: int
    d_model: int
    d_ff: int                # per-expert hidden
    n_experts_padded: int    # physical experts
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # GShard-style dispatch groups: capacity is PER GROUP, each group with
    # its own sort
    n_groups: int = 1


def router_topk(x: torch.Tensor, w_router: torch.Tensor, cfg: MoEConfig
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token-choice top-k routing.

    x: ``[T, D]`` flattened tokens.  Returns (expert ids [T, k] int64,
    combine weights [T, k] in x's dtype, aux load-balancing loss []).
    Padded experts never win (logits -1e30); ties go to the lowest expert
    index, as ``jax.lax.top_k`` breaks them.
    """
    top_e, top_p, me, ce = _route(x, w_router, cfg)
    return top_e, top_p, cfg.n_experts * torch.sum(me * ce)


def _route(x, w_router, cfg: MoEConfig):
    """The routing of :func:`router_topk`, with the balance loss's two
    means (the router's mean probability ``me`` and the routed fraction
    ``ce``, each [Ep]) in place of the loss."""
    logits = x.float() @ w_router.float()                      # [T, Ep]
    if cfg.n_experts_padded > cfg.n_experts:
        pad = torch.arange(cfg.n_experts_padded,
                           device=logits.device) >= cfg.n_experts
        logits = torch.where(pad[None], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    # pick on a detached copy (the picker writes in place); the weights
    # are gathered from ``probs``, so the gradient reaches the router
    top_e = topk_lowest_index(probs.detach(), cfg.top_k)[1]    # [T, k]
    top_p = probs.gather(-1, top_e)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    # Switch-style aux loss: E * sum_e f_e * p_e
    me = probs.mean(0)                                         # [Ep]
    ce = torch.zeros(cfg.n_experts_padded, device=probs.device).index_add_(
        0, top_e.reshape(-1), torch.full((top_e.numel(),),
                                         1.0 / top_e.numel(),
                                         device=probs.device))
    return top_e, top_p.to(x.dtype), me, ce


def dispatch_indices(top_e: torch.Tensor, n_experts: int, capacity: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dispatch plan, over any leading (group) axes.

    Args:
      top_e: ``[..., T, k]`` expert assignment per (token, slot).
    Returns:
      buffer_pos: int64 ``[..., T*k]`` position in the ``[E*C]`` expert
                  buffer (or E*C, a trash slot, when over capacity).
      keep: bool ``[..., T*k]``.
    """
    flat_e = top_e.reshape(*top_e.shape[:-2], -1).long()       # [..., N]
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(-1, order)
    starts = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(flat_e.shape[-1], device=flat_e.device) - starts
    keep_sorted = rank < capacity
    pos_sorted = torch.where(keep_sorted, sorted_e * capacity + rank,
                             n_experts * capacity)
    # invert the sort: buffer position per original (token, slot)
    inv = torch.argsort(order, dim=-1, stable=True)
    return pos_sorted.gather(-1, inv), keep_sorted.gather(-1, inv)


def moe_ffn(x: torch.Tensor, params: dict, cfg: MoEConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full MoE FFN on flattened tokens ``[T, D]`` -> (out, aux_loss).

    Group-local dispatch: tokens are split into ``n_groups`` groups (one
    when ``n_groups`` does not divide T), each with its own capacity and
    its own sort; every expert's SwiGLU runs over its ``[C, D]`` buffer.

    params: router [D, Ep], w_gate/w_up [Ep, D, F], w_down [Ep, F, D].
    """
    if is_dtensor(x):
        return _moe_ffn_mesh(x, params, cfg)
    t = x.shape[0]
    top_e, top_p, aux = router_topk(x, params["router"], cfg)
    out = _dispatch_combine(x, top_e, top_p, params["w_gate"],
                            params["w_up"], params["w_down"], cfg,
                            cfg.n_groups if t % cfg.n_groups == 0 else 1, 0)
    return out, aux


def _dispatch_combine(x, top_e, top_p, w_gate, w_up, w_down,
                      cfg: MoEConfig, g_n: int, e_lo: int) -> torch.Tensor:
    """Dispatch ``x`` [T, D] into ``g_n`` groups' capacity buffers, run the
    experts ``[e_lo, e_lo + w_gate.shape[0])`` (the weights given), and
    combine the slots routed to them -> [T, D] (on one device every
    expert: the whole output)."""
    t, d = x.shape
    ep, k = cfg.n_experts_padded, cfg.top_k
    tg = t // g_n
    capacity = max(8, int(cfg.capacity_factor * tg * k / ep))
    pos, keep = dispatch_indices(top_e.reshape(g_n, tg, k), ep,
                                 capacity)                     # [G, Tg*k]
    xk = x.reshape(g_n, tg, d).repeat_interleave(k, dim=1)     # [G, Tg*k, D]
    # scatter into [G, E*C+1, D] (trash row last: every dropped slot
    # writes its zeros there, the kept positions are distinct)
    buf = x.new_zeros((g_n, ep * capacity + 1, d))
    buf.scatter_(1, pos[..., None].expand(-1, -1, d),
                 torch.where(keep[..., None], xk, 0))
    e_n = w_gate.shape[0]
    h = buf[:, :-1].reshape(g_n, ep, capacity, d)              # [G, E, C, D]
    if e_n != ep:
        h = h[:, e_lo:e_lo + e_n]
        lo = e_lo * capacity
        mine = (pos >= lo) & (pos < lo + e_n * capacity)
        keep = keep & mine
        pos = torch.where(mine, pos - lo, e_n * capacity)

    # expert SwiGLU over every (local) padded expert's buffer
    gt = torch.einsum("gecd,edf->gecf", h, w_gate)
    u = torch.einsum("gecd,edf->gecf", h, w_up)
    y = torch.einsum("gecf,efd->gecd", F.silu(gt) * u, w_down)

    # gather back + weighted combine
    yk = torch.cat([y.reshape(g_n, e_n * capacity, d),
                    y.new_zeros((g_n, 1, d))], 1)
    yk = yk.gather(1, pos[..., None].expand(-1, -1, d))        # [G, Tg*k, D]
    yk = torch.where(keep[..., None], yk, 0)
    w = top_p.reshape(g_n, tg * k, 1).to(yk.dtype)
    out = (yk * w).reshape(g_n, tg, k, d).sum(2)
    return out.reshape(t, d)


def _moe_ffn_mesh(x, params: dict, cfg: MoEConfig):
    """:func:`moe_ffn` on a mesh (see the module's docstring): ``x`` a
    ``DTensor`` [T, D], the expert tensors split over ``model`` (and, with
    ``moe_fsdp``, their d_ff over ``data``)."""
    from torch.distributed.tensor import DTensor, Partial

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    t = x.shape[0]
    dp = mesh.size(names.index("data")) if "data" in names else 1
    local = cfg.n_groups % dp == 0 and t % cfg.n_groups == 0
    x = maybe_shard(x, P("data" if local else None, None))
    tok = tuple(x.placements)                # Shard(0) over data, or not
    model = names.index("model") if "model" in names else None
    tp = mesh.size(model) if model is not None else 1
    split = [p.is_shard() for p in tok]
    n_split = 1
    for i, s_ in enumerate(split):
        if s_:
            n_split *= mesh.size(i)

    def grad_pl(own):
        """A local weight's gradient: partial where the tokens are split
        or the experts contribute partial sums, else its own layout."""
        return [Partial() if split[i] or (i == model and tp > 1
                                          and not own[i].is_shard())
                else own[i] for i in range(mesh.ndim)]

    ws = {n: maybe_shard(params[n], P("model", None, None))  # FSDP d_ff
          for n in ("w_gate", "w_up", "w_down")}         # gathered whole
    local_w = {n: w.to_local(grad_placements=grad_pl(tuple(w.placements)))
               for n, w in ws.items()}
    # this rank's experts
    e_lo = shard_range(cfg.n_experts_padded, mesh,
                       tuple(ws["w_gate"].placements), 0)[0]

    router = params["router"]
    xl = x.to_local(grad_placements=[
        Partial() if i == model and tp > 1 else tok[i]
        for i in range(mesh.ndim)])
    rl = router.to_local(grad_placements=grad_pl(tuple(router.placements)))
    top_e, top_p, me, ce = _route(xl, rl, cfg)
    g_n = cfg.n_groups // dp if local else (
        cfg.n_groups if t % cfg.n_groups == 0 else 1)
    out = _dispatch_combine(xl, top_e, top_p, local_w["w_gate"],
                            local_w["w_up"], local_w["w_down"], cfg, g_n,
                            e_lo)
    out_pl = [Partial() if i == model and tp > 1 else tok[i]
              for i in range(mesh.ndim)]
    out = DTensor.from_local(out, mesh, out_pl, run_check=False,
                             shape=x.shape, stride=x.stride())
    out = maybe_shard(out, P("data" if local else None, None))
    # the balance loss's means over every token: each rank's share, a
    # partial sum over the dims that split the tokens and over model (the
    # model ranks route the same tokens, so each gives 1/tp of its means)
    scale = 1.0 / (n_split * tp)
    mean_pl = [Partial() if split[i] or (i == model and tp > 1)
               else tok[i] for i in range(mesh.ndim)]

    def global_mean(v):
        return replicate(DTensor.from_local(v * scale, mesh, mean_pl,
                                            run_check=False))

    aux = cfg.n_experts * torch.sum(global_mean(me) * global_mean(ce))
    return out, aux


def moe_ffn_dense_oracle(x: torch.Tensor, params: dict, cfg: MoEConfig
                         ) -> torch.Tensor:
    """No-capacity-drop oracle: run every expert on every token, mask by
    routing weights.  O(T*E*F) -- tests only."""
    top_e, top_p, _ = router_topk(x, params["router"], cfg)
    g = torch.einsum("td,edf->tef", x, params["w_gate"])
    u = torch.einsum("td,edf->tef", x, params["w_up"])
    y = torch.einsum("tef,efd->ted", F.silu(g) * u, params["w_down"])
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    weights = x.new_zeros((x.shape[0], cfg.n_experts_padded))
    weights = weights.index_put((rows.expand_as(top_e), top_e), top_p,
                                accumulate=True)
    return torch.einsum("ted,te->td", y, weights)


def _fill_normal(out: torch.Tensor, generator: torch.Generator,
                scale: float) -> torch.Tensor:
    """Fill ``out`` with N(0, 1) * ``scale`` drawn in fp32 on
    ``generator``'s device, one matrix of its last two axes at a time (a
    layer's expert), so that no fp32 copy of the whole tensor exists:
    qwen2-moe's stacked ``w_gate`` in fp32 would be 17.7 GB, and one
    arctic layer's 17.8 GB.  A fake or ``meta`` ``out`` (a parameter tree
    built for its shapes) is left as it is."""
    from torch._subclasses.fake_tensor import is_fake

    if out.is_meta or is_fake(out):
        return out
    flat = out.view(-1, *out.shape[-2:]) if out.dim() > 2 else out[None]
    for i in range(flat.shape[0]):
        x = torch.randn(flat.shape[1:], generator=generator,
                        device=generator.device)
        flat[i].copy_(x * scale)
    return out


def init_moe_params(generator: torch.Generator, cfg: MoEConfig,
                    dtype: torch.dtype = torch.float32,
                    device: str | torch.device | None = None,
                    n_layers: int | None = None) -> dict:
    """Router (fp32) and expert weights scaled as the JAX package's
    ``init_moe_params`` (d**-0.5, d_ff**-0.5), drawn on ``generator``'s
    device in fp32 one expert at a time and stored in ``dtype`` on
    ``device``; ``n_layers`` stacks a leading layer axis."""
    dev = resolve_device(device)
    d, f, ep = cfg.d_model, cfg.d_ff, cfg.n_experts_padded
    lead = () if n_layers is None else (n_layers,)

    def leaf(shape, scale, dt):
        return _fill_normal(torch.empty(lead + shape, dtype=dt, device=dev),
                           generator, scale)

    return {"router": leaf((d, ep), d ** -0.5, torch.float32),
            "w_gate": leaf((ep, d, f), d ** -0.5, dtype),
            "w_up": leaf((ep, d, f), d ** -0.5, dtype),
            "w_down": leaf((ep, f, d), f ** -0.5, dtype)}
