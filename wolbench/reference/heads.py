"""Plain reference of the two WOL heads over query embeddings: the LSS
head (Algorithm 2 with one table: hash the query, read its bucket, score
the bucket's neurons, top-k) and the full head (every neuron, top-k).

``precision="float64"`` is the reference; ``"tf32"`` is the control for
a float32 configuration: every product's operands rounded to TF32.
"""

from __future__ import annotations

import torch

from wolbench.reference.common import (Index, augment, pack, projections,
                                       round_tf32)

__all__ = ["lss_topk", "full_topk"]

_GATHER = 64_000_000        # elements of one block's gathered rows


def _scores(q: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
            precision: str) -> torch.Tensor:
    """``q [B, d] @ w [n, d]^T + b`` (or ``[B, C, d]`` rows a query)."""
    if precision == "tf32":
        q, w = round_tf32(q.float()), round_tf32(w.float())
    else:
        q, w = q.double(), w.double()
    s = torch.einsum("bd,bcd->bc", q, w) if w.dim() == 3 else q @ w.T
    return s if b is None else s + b.to(s.dtype)


def lss_topk(q: torch.Tensor, index: Index, w: torch.Tensor,
             b: torch.Tensor | None, top_k: int, precision: str = "float64"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 2 with one table: ``(logits [B, k], ids [B, k])``, -1 past
    the bucket's neurons.  Ties go to the lower neuron id."""
    if index.n_tables != 1:
        raise NotImplementedError("the reference reads one table (L = 1)")
    rows = max(16, _GATHER // (index.capacity * w.shape[1]))
    outs = [_lss_block(q[i:i + rows], index, w, b, top_k, precision)
            for i in range(0, q.shape[0], rows)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def _lss_block(q, index, w, b, top_k, precision):
    qa = augment(q.double() if precision == "float64" else q.float())
    if precision == "tf32":
        proj = round_tf32(qa / torch.linalg.vector_norm(
            qa, dim=1, keepdim=True).clamp(min=1e-30)) @ round_tf32(
                index.theta.float())
    else:
        proj = projections(qa, index.theta)
    bucket = pack(proj, index.k_bits)[:, 0]
    cand = index.table[0, bucket]                         # [B, P]
    safe = cand.clamp(min=0)
    s = _scores(q, w[safe], None if b is None else b[safe], precision)
    s = torch.where(cand >= 0, s.double(), torch.full_like(s.double(),
                                                           -torch.inf))
    return _topk_low_id(s, cand, top_k)


def full_topk(q: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
              top_k: int,
              precision: str = "float64", rows: int = 256
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every neuron scored: ``(logits [B, k], ids [B, k])``, in blocks of
    ``rows`` queries."""
    outs = []
    for i in range(0, q.shape[0], rows):
        s = _scores(q[i:i + rows], w, b, precision).double()
        outs.append(_topk_low_id(s, torch.arange(
            w.shape[0], device=s.device).expand_as(s), top_k))
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def _topk_low_id(s: torch.Tensor, ids: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of ``s`` in descending order, equal scores among
    them ordered by id."""
    vals, pos = torch.topk(s, k, dim=1)
    picked = ids.gather(1, pos)
    by_id = torch.argsort(picked, dim=1, stable=True)
    order = by_id.gather(1, torch.argsort(-vals.gather(1, by_id), dim=1,
                                          stable=True))
    vals, picked = vals.gather(1, order), picked.gather(1, order)
    picked = torch.where(torch.isfinite(vals), picked,
                         torch.full_like(picked, -1))
    return vals, picked
