"""MIPS baselines from the paper's Table 1 (counterpart of the JAX
package's ``benchmarks/baselines.py``).

* FULL    — exact dense head (the paper's "ideally parallelized" floor).
* SLIDE   — random-SimHash LSS (hash tables, no learning) [MLSys'20].
* PQ      — product quantization with asymmetric distance computation
            (k-means codebooks per subspace; ADC lookup) [Jegou TPAMI'11].
* ip-NSW  — greedy beam search on an exact top-IP neighbor graph
            (fixed-degree, fixed-iteration, batched) [Morozov & Babenko,
            NeurIPS'18].

Each ``*_topk`` returns (top-k ids, candidates scored per query).  Each
``*_build`` draws its random choices from a ``torch.Generator`` and hands
them to a deterministic builder (:func:`slide_index`, :func:`pq_index`,
:func:`ipnsw_index`), so a test can feed the builder the choices that the
JAX package's key makes.  Top-k ties go to the lowest index, as
``lax.top_k`` sends them.

The work that grows with m x m or m x codes x d (the ip-NSW graph's inner
products, k-means distances, PQ's code gather) runs in chunks of at most
``CHUNK_ELEMS`` elements, with the arithmetic of each element unchanged,
so the baselines run at Delicious-200K width (the whole ``w @ w.T`` would
be 169 GB there).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import simhash
from repro_torch.core.lss import (LSSConfig, LSSIndex, avg_sample_size,
                                  build_index, lss_predict, retrieve)
from repro_torch.core.topk import topk_lowest_index

__all__ = ["CHUNK_ELEMS", "full_topk", "slide_index", "slide_build",
           "slide_topk", "PQIndex", "pq_index", "pq_build", "pq_topk",
           "NSWIndex", "ipnsw_index", "ipnsw_build", "ipnsw_topk"]

CHUNK_ELEMS = 2 ** 28      # 1 GiB of fp32 a chunk


def _rows_per_chunk(row_elems: int) -> int:
    return max(1, CHUNK_ELEMS // max(row_elems, 1))


def _topk_stable(x: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` by a stable sort: also right where more than ``k``
    entries tie (a beam padded with ``-inf``)."""
    pos = torch.argsort(-x, dim=-1, stable=True)[..., :k]
    return x.gather(-1, pos), pos


# ------------------------------------------------------------------ FULL --

def full_topk(q: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, int]:
    logits = q @ w.T + b
    return topk_lowest_index(logits, k)[1].to(torch.int32), w.shape[0]


# ----------------------------------------------------------------- SLIDE --

def slide_index(w: torch.Tensor, b: torch.Tensor, theta: torch.Tensor,
                cfg: LSSConfig) -> LSSIndex:
    """The LSS index of the hyperplanes ``theta`` on the neurons [w, b]."""
    return build_index(simhash.augment_neurons(w, b), theta, cfg)


def slide_build(generator: torch.Generator, w: torch.Tensor,
                b: torch.Tensor, cfg: LSSConfig) -> LSSIndex:
    theta = simhash.init_hyperplanes(generator, w.shape[1] + 1, cfg.k_bits,
                                     cfg.n_tables, device=w.device)
    return slide_index(w, b, theta, cfg)


def slide_topk(q: torch.Tensor, index: LSSIndex, k: int
               ) -> tuple[torch.Tensor, float]:
    _, ids = lss_predict(q, index, None, top_k=k)
    cand, _ = retrieve(simhash.augment_queries(q), index)
    return ids, float(avg_sample_size(cand))


# -------------------------------------------------------------------- PQ --

class PQIndex(NamedTuple):
    codebooks: torch.Tensor   # [M, 256, d_sub]
    codes: torch.Tensor       # [m, M] int32
    bias: torch.Tensor        # [m]


def _nearest(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Per row of ``x``, the first centroid of least squared distance."""
    rows = _rows_per_chunk(cent.numel())
    return torch.cat([((x[i:i + rows, None] - cent[None]) ** 2).sum(-1)
                      .argmin(1) for i in range(0, x.shape[0], rows)])


def _kmeans(x: torch.Tensor, start: torch.Tensor, n_iters: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's steps from the rows ``start``; a centroid that no row picks
    stays where it was."""
    cent = x[start.long()]
    n_codes = cent.shape[0]
    for _ in range(n_iters):
        assign = _nearest(x, cent)
        sums = torch.zeros_like(cent).index_add_(0, assign, x)
        cnt = torch.zeros(n_codes, dtype=x.dtype, device=x.device
                          ).index_add_(0, assign, torch.ones_like(x[:, 0]))
        cent = torch.where(cnt[:, None] > 0,
                           sums / cnt.clamp(min=1)[:, None], cent)
    return cent, _nearest(x, cent).to(torch.int32)


def _subspaces(x: torch.Tensor, n_subspaces: int) -> torch.Tensor:
    """``[n, d] -> [n, M, d_sub]``, d zero-padded to a multiple of M."""
    xp = F.pad(x, (0, (-x.shape[1]) % n_subspaces))
    return xp.reshape(x.shape[0], n_subspaces, -1)


def pq_index(w: torch.Tensor, b: torch.Tensor, starts: torch.Tensor,
             n_iters: int = 12) -> PQIndex:
    """k-means over each of the ``M = starts.shape[0]`` subspaces of w,
    subspace ``j`` starting from the rows ``starts[j]`` (``[M, n_codes]``)."""
    sub = _subspaces(w, starts.shape[0])
    cents, codes = zip(*(_kmeans(sub[:, j], starts[j], n_iters)
                         for j in range(starts.shape[0])))
    return PQIndex(torch.stack(cents), torch.stack(codes, dim=1), b)


def pq_build(generator: torch.Generator, w: torch.Tensor, b: torch.Tensor,
             n_subspaces: int = 8, n_iters: int = 12, n_codes: int = 256
             ) -> PQIndex:
    """Each subspace's starting rows: ``n_codes`` distinct rows of w, or
    drawn with replacement where w has fewer."""
    m = w.shape[0]
    gdev = generator.device
    starts = torch.stack([
        torch.randint(0, m, (n_codes,), generator=generator, device=gdev)
        if m < n_codes else
        torch.randperm(m, generator=generator, device=gdev)[:n_codes]
        for _ in range(n_subspaces)])
    return pq_index(w, b, starts.to(w.device), n_iters)


def pq_topk(q: torch.Tensor, index: PQIndex, k: int
            ) -> tuple[torch.Tensor, int]:
    """ADC: per-subspace inner-product tables, then a code gather-sum."""
    m_sub = index.codebooks.shape[0]
    tables = torch.einsum("bmd,mcd->bmc", _subspaces(q, m_sub),
                          index.codebooks)                    # [B, M, 256]
    sub = torch.arange(m_sub, device=q.device)[None, :]
    codes = index.codes.long()
    rows = _rows_per_chunk(codes.numel())
    scores = torch.cat([tables[i:i + rows][:, sub, codes].sum(-1)
                        for i in range(0, q.shape[0], rows)]) + index.bias
    return topk_lowest_index(scores, k)[1].to(torch.int32), codes.shape[0]


# ---------------------------------------------------------------- ip-NSW --

class NSWIndex(NamedTuple):
    graph: torch.Tensor       # [m, R] neighbor ids by best inner product
    w: torch.Tensor
    b: torch.Tensor
    entry: torch.Tensor       # [n_entries] entry points


def ipnsw_index(w: torch.Tensor, b: torch.Tensor, entry: torch.Tensor,
                degree: int = 16) -> NSWIndex:
    """Each neuron's ``degree`` best others by ``w_i . w_j + b_j``, in
    blocks of rows."""
    m = w.shape[0]
    rows = _rows_per_chunk(m)
    graph = []
    for i in range(0, m, rows):
        ip = w[i:i + rows] @ w.T + b[None, :]
        n = ip.shape[0]
        ip[torch.arange(n, device=w.device),
           torch.arange(i, i + n, device=w.device)] = float("-inf")
        graph.append(topk_lowest_index(ip, degree)[1].to(torch.int32))
    return NSWIndex(torch.cat(graph), w, b, entry.to(torch.int32))


def ipnsw_build(generator: torch.Generator, w: torch.Tensor,
                b: torch.Tensor, degree: int = 16, n_entries: int = 8
                ) -> NSWIndex:
    entry = torch.randperm(w.shape[0], generator=generator,
                           device=generator.device)[:n_entries]
    return ipnsw_index(w, b, entry.to(w.device), degree)


def _dedup_sorted(ids: torch.Tensor, s: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort each row by score (stable), then drop to ``-inf`` every entry
    whose id equals its left neighbour's."""
    order = torch.argsort(-s, dim=-1, stable=True)
    ids, s = ids.gather(-1, order), s.gather(-1, order)
    dup = torch.cat([torch.zeros_like(ids[:, :1], dtype=torch.bool),
                     ids[:, 1:] == ids[:, :-1]], dim=-1)
    return ids, torch.where(dup, torch.full_like(s, float("-inf")), s)


def ipnsw_topk(q: torch.Tensor, index: NSWIndex, k: int, beam: int = 32,
               n_steps: int = 12) -> tuple[torch.Tensor, int]:
    """Batched greedy beam search; every query visits
    ``n_entries + n_steps * beam * degree`` candidates (static)."""
    bsz = q.shape[0]
    r = index.graph.shape[1]

    def score(ids):                                     # [B, n] -> [B, n]
        return torch.bmm(index.w[ids.long()], q[:, :, None])[..., 0] \
            + index.b[ids.long()]

    cand = index.entry[None, :].expand(bsz, -1)
    pad = beam - cand.shape[1]
    ids = F.pad(cand, (0, pad), value=0)
    s = F.pad(score(cand), (0, pad), value=float("-inf"))
    hist_ids, hist_s = [], []
    for _ in range(n_steps):
        nbrs = index.graph[ids.long()].reshape(bsz, -1)   # [B, beam*R]
        all_ids, all_s = _dedup_sorted(torch.cat([ids, nbrs], dim=1),
                                       torch.cat([s, score(nbrs)], dim=1))
        s, pos = _topk_stable(all_s, beam)
        ids = all_ids.gather(-1, pos)
        hist_ids.append(ids)
        hist_s.append(s)
    flat_ids, flat_s = _dedup_sorted(torch.cat(hist_ids, dim=1),
                                     torch.cat(hist_s, dim=1))
    _, pos = _topk_stable(flat_s, k)
    return flat_ids.gather(-1, pos), index.entry.shape[0] + n_steps * beam * r
