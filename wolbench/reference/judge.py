"""The comparison that decides ``correct``: the program's answers held
against the plain reference, row by row.

Three numbers, each the largest over the rows compared, each scale-free
(a logit difference is taken over the largest |reference logit| among
the neurons the row's bucket holds, or among all neurons for the full
head):

* ``hash_flip_margin`` (LSS heads): a returned neuron whose bucket, in
  the reference's own index, is not the query's bucket must be explained
  by rounding: every bit in which the two buckets differ must lie near a
  hyperplane, for the query or for the neuron.  The number is the
  largest such bit's margin, ``min(|theta_j . q/|q||, |theta_j .
  c/|c||)``; 0 when every returned neuron lies in the query's bucket; inf
  for a neuron no bucket holds.
* ``rank_gap``: the k-th best reference logit among the neurons the
  program's bucket holds (every neuron for the full head), less the
  reference logit of the program's k-th answer.  About 0 for a program
  that ranks what it scores; large for a wrong, missing or repeated
  answer.
* ``logit_err`` (where the program returns logits): its logit against
  the reference logit of the same neuron.

Besides, ``flip_share`` (LSS heads): the share of rows one of whose
answers lies outside the query's bucket in the reference's index.

Neurons whose own hash lies within ``NEURON_TOL`` of a hyperplane may
sit in either of two buckets in an index built in float32: the reference
leaves them out of a bucket's ranking unless the program returned them.
"""

from __future__ import annotations

import math

import torch

from wolbench.reference.common import Index, augment, pack, projections

__all__ = ["NEURON_TOL", "judge_lss", "judge_full", "merge"]

NEURON_TOL = 1e-4
_GATHER = 64_000_000        # float64 elements of one block's gathered rows


def _scores(q: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
            ids: torch.Tensor) -> torch.Tensor:
    """float64 ``q . w[ids] + b[ids]`` for ids ``[B, n]`` (clamped)."""
    safe = ids.clamp(min=0)
    s = torch.einsum("bd,bnd->bn", q.double(), w[safe].double())
    if b is not None:
        s = s + b[safe].double()
    return s


def _gaps(kth: torch.Tensor, ref_prog: torch.Tensor, valid: torch.Tensor,
          scale: torch.Tensor) -> torch.Tensor:
    """Per answer: (k-th best - reference logit of the answer) / scale; an
    answer missing where the reference has one is inf."""
    gap = (kth - ref_prog) / scale[:, None]
    gap = torch.where(valid, gap, torch.where(torch.isfinite(kth),
                                              torch.full_like(gap, math.inf),
                                              torch.zeros_like(gap)))
    return torch.nan_to_num(gap, nan=0.0, posinf=math.inf, neginf=0.0)


def judge_lss(q: torch.Tensor, index: Index, w: torch.Tensor,
              b: torch.Tensor | None, ids: torch.Tensor,
              logits: torch.Tensor | None = None) -> dict:
    """Hold LSS answers (``ids [B, k]``, -1 = none, and ``logits``)
    against the reference for the float64 queries ``q [B, d]``."""
    out = {"rows": 0, "flipped": 0, "hash_flip_margin": 0.0, "rank_gap": 0.0}
    if logits is not None:
        out["logit_err"] = 0.0
    k_bits = index.k_bits
    bit = torch.arange(k_bits, device=q.device)
    block = max(16, _GATHER // (index.capacity * w.shape[1]))
    for i in range(0, q.shape[0], block):
        qb = q[i:i + block].double()
        idb = ids[i:i + block].to(q.device).long()
        valid = idb >= 0
        safe = idb.clamp(min=0)
        proj = projections(augment(qb), index.theta)[:, :k_bits]
        b_ref = pack(proj, k_bits)[:, 0]
        bo = index.bucket_of[safe, 0]
        diff = (((bo ^ b_ref[:, None])[..., None] >> bit) & 1).bool()
        margin = torch.minimum(proj.abs()[:, None, :],
                               index.margin[safe][..., :k_bits])
        flip = torch.where(diff, margin, torch.zeros_like(margin)).amax(-1)
        flip = torch.where(valid & (bo < 0), torch.full_like(flip, math.inf),
                           torch.where(valid, flip, torch.zeros_like(flip)))
        # the program's bucket is its first answer's
        b_prog = torch.where(bo[:, 0] >= 0, bo[:, 0], b_ref)
        cand = index.table[0, b_prog]                            # [B, P]
        returned = (cand[:, :, None] == idb[:, None, :]).any(-1)
        amb = index.margin[cand.clamp(min=0)][..., :k_bits].amin(-1) \
            < NEURON_TOL
        keep = (cand >= 0) & (returned | ~amb)
        s = torch.where(keep, _scores(qb, w, b, cand),
                        torch.full(cand.shape, -math.inf, dtype=torch.float64,
                                   device=q.device))
        k = idb.shape[1]
        kth = torch.topk(s, k, dim=1).values
        scale = torch.where(keep, s.abs(), torch.zeros_like(s)).amax(1)
        scale = scale.clamp(min=1e-300)
        ref_prog = _scores(qb, w, b, idb)
        out["hash_flip_margin"] = max(out["hash_flip_margin"],
                                      float(flip.max()))
        out["flipped"] += int(((diff.any(-1) | (bo < 0)) & valid).any(1)
                              .sum())
        out["rank_gap"] = max(out["rank_gap"], float(
            _gaps(kth, ref_prog, valid, scale).max()))
        if logits is not None:
            lg = logits[i:i + block].to(q.device).double()
            err = torch.where(valid, (lg - ref_prog).abs() / scale[:, None],
                              torch.zeros_like(lg))
            out["logit_err"] = max(out["logit_err"], float(err.max()))
        out["rows"] += qb.shape[0]
    return _share(out)


def judge_full(q: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
               ids: torch.Tensor, logits: torch.Tensor | None = None,
               rows: int = 256) -> dict:
    """Hold full-head answers against every neuron's reference logit."""
    out = {"rows": 0, "rank_gap": 0.0}
    if logits is not None:
        out["logit_err"] = 0.0
    wd = w.double()
    bd = None if b is None else b.double()
    for i in range(0, q.shape[0], rows):
        qb = q[i:i + rows].double()
        idb = ids[i:i + rows].to(q.device).long()
        valid = idb >= 0
        s = qb @ wd.T
        if bd is not None:
            s = s + bd
        kth = torch.topk(s, idb.shape[1], dim=1).values
        scale = s.abs().amax(1).clamp(min=1e-300)
        ref_prog = s.gather(1, idb.clamp(min=0))
        out["rank_gap"] = max(out["rank_gap"], float(
            _gaps(kth, ref_prog, valid, scale).max()))
        if logits is not None:
            lg = logits[i:i + rows].to(q.device).double()
            err = torch.where(valid, (lg - ref_prog).abs() / scale[:, None],
                              torch.zeros_like(lg))
            out["logit_err"] = max(out["logit_err"], float(err.max()))
        out["rows"] += qb.shape[0]
    return out


def _share(out: dict) -> dict:
    if "flipped" in out:
        out["flip_share"] = out["flipped"] / max(out["rows"], 1)
    return out


def merge(parts: list[dict]) -> dict:
    """Numbers of several judged groups as one: the largest of each, the
    rows summed."""
    out: dict = {}
    for p in parts:
        for key, value in p.items():
            out[key] = (out.get(key, 0) + value if key in ("rows", "flipped")
                        else max(out.get(key, 0.0), value))
    return _share(out)
