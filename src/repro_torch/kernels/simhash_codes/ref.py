"""Plain PyTorch version of the ``simhash_codes`` kernel."""

from __future__ import annotations

import torch


def simhash_codes_ref(x: torch.Tensor, theta: torch.Tensor, k_bits: int,
                      n_tables: int) -> torch.Tensor:
    """``[B, d] x [d, K*L] -> int32 bucket ids [B, L]``.

    Bits ``x @ theta > 0`` packed little-endian within each table.  No
    normalisation: the caller passes unit rows (sign is scale-invariant).
    """
    bits = (x.float() @ theta.float()) > 0
    shaped = bits.reshape(x.shape[0], n_tables, k_bits)
    weights = 2 ** torch.arange(k_bits, dtype=torch.int32, device=x.device)
    return (shaped.to(torch.int32) * weights).sum(-1, dtype=torch.int32)
