"""GCN (Kipf & Welling, arXiv:1609.02907) in PyTorch (counterpart of
``repro.models.gnn``).

Message passing is a scatter-add over an edge list (``index_add_`` where
the JAX package has ``segment_sum``)::

    h' = ReLU( D^-1/2 (A + I) D^-1/2  h  W )

The scatter adds in another order than JAX's ``segment_sum``, so the two
agree within a tolerance, not bit for bit.

On a mesh (``DTensor`` leaves: the parameters replicated, as
``param_specs`` lays them out, the batch split over ``data``), the graph
is gathered whole on every rank (:func:`gathered`: one all-gather a
batch leaf) and every rank runs the same full-graph step, so the
gradients are whole on every rank and need no reduction: message passing
reads any node's neighbours, which a row split of the nodes would make a
gather of its own.

Execution shapes (the reference's cells): a full-batch step on ``[N, F]``
features and an ``[E, 2]`` edge list; layer-wise neighbour sampling
(:func:`sampled_subgraph`) then GCN on the sampled block; batched small
graphs with a mean-pool readout (:func:`molecule_loss`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.utils.sharding import P, full_tensor, to_local
from repro_torch.utils.tree import tree_map

__all__ = ["GCNConfig", "init_params", "param_specs", "forward", "loss",
           "molecule_loss", "gathered", "seeded_generator", "sample_block",
           "sampled_subgraph"]


class GCNConfig(NamedTuple):
    name: str
    n_layers: int = 2
    d_feat: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    aggregator: str = "mean"    # sym-normalized mean
    readout: str = "none"       # "mean" for graph-level tasks
    dtype: torch.dtype = torch.float32

    def param_count(self) -> int:
        dims = [self.d_feat] + [self.d_hidden] * (self.n_layers - 1) \
            + [self.n_classes]
        return sum(dims[i] * dims[i + 1] + dims[i + 1]
                   for i in range(len(dims) - 1))


def init_params(generator: torch.Generator, cfg: GCNConfig,
                device: str | torch.device | None = None) -> dict:
    """Weights N(0, 1) * d_in**-0.5 (drawn on ``generator``'s device),
    zero biases, on ``device``."""
    dev = resolve_device(device)
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    ws = []
    for i in range(len(dims) - 1):
        w = torch.randn((dims[i], dims[i + 1]), generator=generator,
                        device=generator.device) * dims[i] ** -0.5
        ws.append(w.to(device=dev, dtype=cfg.dtype))
    return {"w": ws,
            "b": [torch.zeros((dims[i + 1],), dtype=cfg.dtype, device=dev)
                  for i in range(len(dims) - 1)]}


def param_specs(cfg: GCNConfig) -> dict:
    return {"w": [P(None, None)] * cfg.n_layers,
            "b": [P(None)] * cfg.n_layers}


def _sym_norm_agg(h: torch.Tensor, edges: torch.Tensor, n_nodes: int
                  ) -> torch.Tensor:
    """Symmetric-normalized aggregation with self loops.

    h: [N, D]; edges: int [E, 2] (src, dst), -1 rows = padding.
    """
    src, dst = edges[:, 0].long(), edges[:, 1].long()
    valid = src >= 0
    s = torch.where(valid, src, 0)
    t = torch.where(valid, dst, 0)
    ones = valid.float()
    deg = torch.ones((n_nodes,), dtype=torch.float32, device=h.device)
    deg = deg.index_add(0, t, ones)                          # + self loop
    inv_sqrt = torch.rsqrt(deg)
    coef = (inv_sqrt[s] * inv_sqrt[t] * ones)[:, None].to(h.dtype)
    msgs = h[s] * coef
    agg = torch.zeros_like(h).index_add_(0, t, msgs)
    return agg + h * (inv_sqrt ** 2)[:, None].to(h.dtype)


def forward(params: dict, x: torch.Tensor, edges: torch.Tensor,
            cfg: GCNConfig) -> torch.Tensor:
    """x: [N, F], edges: [E, 2] -> logits [N, C] (or [C] after readout)."""
    h = x.to(cfg.dtype)
    n = x.shape[0]
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        h = _sym_norm_agg(h, edges, n) @ w + b
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
    if cfg.readout == "mean":
        h = h.mean(0)
    return h.float()


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels.clamp(min=0).long()[:, None])[:, 0]
    return logz - gold


def gathered(params: dict, batch: dict) -> tuple[dict, dict]:
    """``(params, batch)`` as plain tensors: each ``DTensor`` batch leaf
    gathered whole, each parameter's local tensor (its gradient comes
    back laid out as the parameter).  Plain trees pass as they are."""
    return (tree_map(to_local, params),
            {k: full_tensor(v) for k, v in batch.items()})


def loss(params: dict, batch: dict, cfg: GCNConfig) -> torch.Tensor:
    """batch: x [N,F], edges [E,2], labels [N] (-1 = not in train mask)."""
    params, batch = gathered(params, batch)
    logits = forward(params, batch["x"], batch["edges"], cfg)
    mask = batch["labels"] >= 0
    return (_nll(logits, batch["labels"]) * mask).sum() / mask.sum().clamp(
        min=1)


def molecule_loss(params: dict, batch: dict, cfg: GCNConfig) -> torch.Tensor:
    """Batched small graphs: x [G,n,F], edges [G,e,2], labels [G] (one
    forward a graph, where JAX maps)."""
    params, batch = gathered(params, batch)
    logits = torch.stack([forward(params, x, e, cfg)
                          for x, e in zip(batch["x"], batch["edges"])])
    return _nll(logits, batch["labels"]).mean()


# -------------------------------------------------------- neighbor sampler --

def seeded_generator(seed: torch.Tensor) -> torch.Generator:
    """A generator on ``seed``'s device seeded with its value (a 0-d int
    tensor: the sampled cell's seed, where JAX takes a key).  A fake or
    ``meta`` seed has no value: the generator is then left unseeded,
    which a fake or meta draw ignores."""
    from torch._subclasses.fake_tensor import is_fake

    seed = to_local(seed)
    gen = torch.Generator(device=seed.device if seed.device.type != "meta"
                          else "cpu")
    if not is_fake(seed) and seed.device.type != "meta":
        gen.manual_seed(int(seed))
    return gen


def sample_block(generator: torch.Generator, indptr: torch.Tensor,
                 indices: torch.Tensor, seeds: torch.Tensor, fanout: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-hop uniform neighbor sampling (with replacement) from CSR.

    seeds: [B] node ids. Returns (neighbors [B, fanout], edges [B*fanout, 2]
    as (neighbor -> seed) pairs).  Isolated nodes self-loop.  Draws on
    ``generator`` (its device must be the tensors')."""
    seeds = seeds.long()
    start = indptr[seeds].long()
    deg = indptr[seeds + 1].long() - start                   # [B]
    r = torch.randint(0, 1 << 30, (seeds.shape[0], fanout),
                      generator=generator, device=seeds.device)
    off = r % deg.clamp(min=1)[:, None]
    idx = (start[:, None] + off).clamp(max=max(indices.numel() - 1, 0))
    nbrs = torch.where(deg[:, None] > 0, indices[idx].long(), seeds[:, None])
    edges = torch.stack([nbrs.reshape(-1),
                         seeds.repeat_interleave(fanout)], dim=1)
    return nbrs, edges


def sampled_subgraph(generator: torch.Generator, indptr: torch.Tensor,
                     indices: torch.Tensor, seeds: torch.Tensor,
                     fanouts: tuple[int, ...]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-hop sampling: returns (node ids [N_blk], edges [E_blk, 2])
    with LOCAL node indexing (position in the node-id array).

    Static shapes: N_blk = B * prod(1 + fanout ...); duplicate nodes are
    kept (extra compute, exact result)."""
    frontier = seeds.long()
    all_nodes = [frontier]
    all_edges = []
    offset = 0
    dev = frontier.device
    for f in fanouts:
        nbrs, _ = sample_block(generator, indptr, indices, frontier, f)
        flat = nbrs.reshape(-1)
        # local edges: neighbour j of frontier node i -> (nbr_pos, i_pos)
        nbr_pos = sum(n.shape[0] for n in all_nodes) + torch.arange(
            flat.shape[0], device=dev)
        dst_pos = offset + torch.arange(
            frontier.shape[0], device=dev).repeat_interleave(f)
        all_edges.append(torch.stack([nbr_pos, dst_pos], 1))
        offset = sum(n.shape[0] for n in all_nodes)
        all_nodes.append(flat)
        frontier = flat
    return (torch.cat(all_nodes),
            torch.cat(all_edges).to(torch.int32))
