"""Static-shape, bucket-major LSH tables (counterpart of
``repro.core.tables``).

A table is ``table_ids: int32 [L, 2^K, P]`` — neuron ids, bucket-major,
-1 padded — and the optional bucket-major weight layout
``[L, 2^K, P, d_aug]`` puts the rows a query touches in one contiguous
``[P, d_aug]`` slab per table.  Buckets that overflow capacity ``P`` are
truncated; the count is kept in ``n_dropped``.  Empty (-1) slots are zero
rows: they score 0 and are masked by id before ranking.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import simhash

__all__ = ["LSSTables", "build_tables", "bucketize_weights",
           "bucket_load_stats"]


class LSSTables(NamedTuple):
    """The static LSS index for one WOL."""

    table_ids: torch.Tensor   # int32 [L, 2^K, P], -1 = empty slot
    n_dropped: torch.Tensor   # int32 [L] neurons truncated by overflow
    k_bits: int
    n_tables: int
    capacity: int             # P

    @property
    def n_buckets(self) -> int:
        return 2 ** self.k_bits


def _one_table(bucket_of_neuron: torch.Tensor, n_buckets: int,
               capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One bucket-major table from per-neuron bucket ids ``[m]``: stable
    sort by bucket, rank within the bucket by a searchsorted offset,
    scatter ranks < P into the table and the rest into a trash slot."""
    m = bucket_of_neuron.shape[0]
    dev = bucket_of_neuron.device
    buckets = bucket_of_neuron.long()
    order = torch.argsort(buckets, stable=True)
    sorted_buckets = buckets[order]
    starts = torch.searchsorted(sorted_buckets, sorted_buckets, side="left")
    rank = torch.arange(m, device=dev) - starts
    keep = rank < capacity
    trash = n_buckets * capacity
    flat_pos = torch.where(keep, sorted_buckets * capacity + rank,
                           torch.full_like(rank, trash))
    flat = torch.full((trash + 1,), -1, dtype=torch.int32, device=dev)
    # only the trash slot can take several writes, and it is cut off
    flat.scatter_(0, flat_pos, order.to(torch.int32))
    ids = flat[:-1].reshape(n_buckets, capacity)
    return ids, (~keep).sum(dtype=torch.int32)


def build_tables(w_aug: torch.Tensor, theta: torch.Tensor, k_bits: int,
                 n_tables: int, capacity: int) -> LSSTables:
    """Hash every neuron ``[m, d_aug]`` and build L bucket-major tables."""
    buckets = simhash.bucket_ids(w_aug, theta, k_bits, n_tables)   # [m, L]
    tables = [_one_table(buckets[:, t], 2 ** k_bits, capacity)
              for t in range(n_tables)]
    ids = torch.stack([t[0] for t in tables])
    dropped = torch.stack([t[1] for t in tables])
    return LSSTables(ids, dropped, k_bits, n_tables, capacity)


def bucketize_weights(w_aug: torch.Tensor, tables: LSSTables) -> torch.Tensor:
    """The bucket-major weight layout ``[L, 2^K, P, d_aug]``; empty slots
    are zero rows."""
    ids = tables.table_ids
    w = w_aug[ids.clamp(min=0).long()]
    return torch.where((ids >= 0)[..., None], w, torch.zeros_like(w))


def bucket_load_stats(tables: LSSTables) -> dict[str, torch.Tensor]:
    """Load-balance metrics for capacity tuning."""
    occ = (tables.table_ids >= 0).sum(-1)                 # [L, 2^K]
    total = occ.sum(-1) + tables.n_dropped                # [L] == m
    return {
        "mean_bucket_occupancy": occ.float().mean(),
        "max_bucket_occupancy": occ.max(),
        "empty_bucket_frac": (occ == 0).float().mean(),
        "overflow_frac": (tables.n_dropped / total.clamp(min=1)).mean(),
    }
