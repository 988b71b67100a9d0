"""Top-k with the tie order of ``jax.lax.top_k``: the lowest index first.

``torch.topk`` does not promise an order among equal values, and the
parity contract compares ids exactly, so every top-k of the port goes
through :func:`topk_lowest_index`.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "topk_lowest_index"]

NEG_INF = -1e30      # the logit of a masked slot (repro.core.lss.NEG_INF)


def topk_lowest_index(x: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the k largest entries along the last axis,
    in descending order, ties to the lowest index.

    k passes of a max: ``torch.argmax`` returns the first maximal index,
    and a picked entry drops to ``-inf``.
    """
    work = x.clone()
    vals, idx = [], []
    for _ in range(k):
        pos = torch.argmax(work, dim=-1, keepdim=True)
        vals.append(work.gather(-1, pos))
        idx.append(pos)
        work.scatter_(-1, pos, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idx, dim=-1)
