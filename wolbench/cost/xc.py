"""Operations and bytes of the XC scoring step (frozen from the bounds the
port's smoke script printed beside its kernel times).

``lss_topk``: each distinct slab a batch hits is read once (its P ids,
and the rows of its occupied slots), with the queries, theta and the
outputs; 2*(d+1) operations per occupied slot per query, in float32.
The full head: W and b read once, the embedding bag's rows and ids, the
top-k out; 2*d*m operations per query.  ``mfu``'s work a row: the
embedding bag's adds (one a feature a hidden unit), then either the
hash (2*(d+1)*K*L) and the scored candidates (2*(d+1) each), or
2*d*m + m.
"""

from __future__ import annotations

from wolbench.cost.peaks import bound_s

__all__ = ["lss_topk_bytes", "lss_topk_flops", "lss_topk_bound_s",
           "full_step_bytes", "full_step_bound_s",
           "batch_flops"]


def lss_topk_bytes(n_queries: int, d_aug: int, k_bits: int, n_tables: int,
                   capacity: int, distinct_slabs: int,
                   distinct_occupied: int, top_k: int,
                   row_bytes: int | None = None) -> int:
    """Bytes one ``lss_topk`` call needs: ``distinct_slabs`` slabs hit,
    holding ``distinct_occupied`` occupied slots among them."""
    row = 4 * d_aug if row_bytes is None else row_bytes
    return (distinct_slabs * capacity * 4 + distinct_occupied * row
            + 4 * n_queries * d_aug + 4 * d_aug * k_bits * n_tables
            + 4 * n_queries * n_tables * capacity + 8 * n_queries * top_k
            + 4 * n_queries)


def lss_topk_flops(d_aug: int, scored: int) -> int:
    """2*(d+1) a scored (occupied) slot, over the batch's queries."""
    return 2 * d_aug * scored


def lss_topk_bound_s(n_queries: int, d_aug: int, k_bits: int, n_tables: int,
                     capacity: int, distinct_slabs: int,
                     distinct_occupied: int, scored: int, top_k: int) -> float:
    return bound_s(lss_topk_bytes(n_queries, d_aug, k_bits, n_tables,
                                  capacity, distinct_slabs, distinct_occupied,
                                  top_k),
                   lss_topk_flops(d_aug, scored))


def full_step_bytes(n_queries: int, max_in: int, distinct_features: int,
                    d: int, m: int, top_k: int) -> int:
    """The full-head step: the embedding bag's ids ``[B, max_in]`` and
    the distinct rows they name, W and b, the top-k logits and ids out."""
    return (4 * n_queries * max_in + 4 * distinct_features * d
            + 4 * m * d + 4 * m + 8 * n_queries * top_k)


def full_step_bound_s(n_queries: int, max_in: int, n_features: int,
                      distinct_features: int, d: int, m: int,
                      top_k: int) -> float:
    return bound_s(full_step_bytes(n_queries, max_in, distinct_features, d,
                                   m, top_k),
                   batch_flops(n_queries, n_features, d, "full", m=m))


def batch_flops(n_rows: int, n_features: int, d: int, head: str, *,
                m: int = 0, k_bits: int = 0, n_tables: int = 0,
                scored: int = 0) -> int:
    """Useful operations of a batch of ``n_rows`` rows holding
    ``n_features`` valid features: the bag's adds, then for ``head``
    ``lss`` the hash and ``scored`` candidates, for ``full`` every one of
    ``m`` neurons."""
    bag = n_features * d
    if head == "full":
        return bag + n_rows * (2 * d * m + m)
    return bag + n_rows * 2 * (d + 1) * k_bits * n_tables \
        + 2 * (d + 1) * scored
