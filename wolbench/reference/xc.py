"""Plain reference of the paper's XC model below its output layer:
EmbeddingBag(mean) -> ReLU, the LSS query.  The heads on top of it are
``wolbench.reference.heads``.

The reference computes in float64 from the float32 table; the control
(TF32) takes the bag in float32, as the program computes it.
"""

from __future__ import annotations

import torch

__all__ = ["embed_bag"]


def embed_bag(table: torch.Tensor, ids: torch.Tensor,
              dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """ReLU of the mean of the rows of ``table`` at ``ids`` ``[B, F]``
    (-1 = padding; a repeated id counts each time it appears)."""
    ids = ids.to(table.device).long()
    valid = ids >= 0
    rows = table[ids.clamp(min=0)].to(dtype) * valid[..., None].to(dtype)
    count = valid.sum(1, keepdim=True).clamp(min=1).to(dtype)
    return torch.relu(rows.sum(1) / count)
