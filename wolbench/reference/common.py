"""Plain pieces shared by the references: SimHash codes, the bucket-major
index with capacity P, and the two lower-precision emulations the
controls use.

Written from the paper's Algorithm 2 and the port's documented
conventions (neurons augmented with their bias, queries with a zero;
bit j of a table weighs 2**j; a bucket keeps its first P neurons in id
order), not from the port's code.  Hash projections are taken in
float64, so the reference's bucket of a vector is exact up to float64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Index", "augment", "projections", "pack", "build_index",
           "round_tf32", "fp8_rows", "no_tf32"]


class no_tf32:
    """Run a block with TF32 off for float32 products on the card, and
    put the flags back afterwards."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved


def augment(x: torch.Tensor, last: torch.Tensor | None = None
            ) -> torch.Tensor:
    """``[n, d] -> [n, d+1]``: ``last`` (a neuron's bias) or 0 appended."""
    tail = (x.new_zeros((x.shape[0], 1)) if last is None
            else last.reshape(-1, 1).to(x.dtype))
    return torch.cat([x, tail], dim=1)


def projections(x_aug: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """``theta^T (x / |x|)`` in float64, ``[n, K*L]``; a zero row gives 0."""
    x = x_aug.double()
    norm = torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=1e-300)
    return (x / norm) @ theta.double()


def pack(proj: torch.Tensor, k_bits: int) -> torch.Tensor:
    """Sign bits ``proj > 0`` ``[n, K*L]`` -> int64 buckets ``[n, L]``."""
    n = proj.shape[0]
    bits = (proj > 0).long().reshape(n, -1, k_bits)
    weights = 2 ** torch.arange(k_bits, device=proj.device)
    return (bits * weights).sum(-1)


class Index(NamedTuple):
    """The reference's own index, rebuilt from W, b and theta."""

    theta: torch.Tensor        # [d+1, K*L] as handed to both sides
    table: torch.Tensor        # int64 [L, 2^K, P], -1 = empty slot
    bucket_of: torch.Tensor    # int64 [m, L]: -1 where a bucket was full
    margin: torch.Tensor       # float64 [m, K*L]: |projection| of each neuron
    k_bits: int
    n_tables: int
    capacity: int


def build_index(w: torch.Tensor, b: torch.Tensor | None, theta: torch.Tensor,
                k_bits: int, n_tables: int, capacity: int,
                rows: int = 1 << 16) -> Index:
    """Hash every neuron ``[w_i, b_i]`` and fill each table's buckets in
    neuron-id order, keeping the first ``capacity`` of each."""
    m = w.shape[0]
    proj = torch.cat([
        projections(augment(w[i:i + rows].float(),
                            None if b is None else b[i:i + rows].float()),
                    theta) for i in range(0, m, rows)])
    buckets = pack(proj, k_bits)                          # [m, L]
    n_buckets = 2 ** k_bits
    table = torch.full((n_tables, n_buckets, capacity), -1, dtype=torch.long,
                       device=w.device)
    bucket_of = torch.full((m, n_tables), -1, dtype=torch.long,
                           device=w.device)
    ids = torch.arange(m, device=w.device)
    for t in range(n_tables):
        key = buckets[:, t] * m + ids                     # bucket, then id
        order = torch.argsort(key)
        sb = buckets[order, t]
        counts = torch.bincount(sb, minlength=n_buckets)
        start = torch.cumsum(counts, 0) - counts
        rank = torch.arange(m, device=w.device) - start[sb]
        keep = rank < capacity
        table[t, sb[keep], rank[keep]] = order[keep]
        bucket_of[order[keep], t] = sb[keep]
    return Index(theta, table, bucket_of, proj.abs(), k_bits, n_tables,
                 capacity)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero): what a TF32 product reads of its operands."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale a row (the row's largest
    magnitude maps to 448), back in float32: an fp8 operand of a product."""
    x = x.float()
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale
