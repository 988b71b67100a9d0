"""Index Update Loss (paper §3.3): learn the hyperplanes (counterpart of
``repro.core.iul``).

The learning signal is retrieval-aware: pairs are mined against the
CURRENT tables —

  positive (q, w_y):  label y missed by the retrieved set S and q·w_y > t1
  negative (q, w_i):  i ∈ S, not a label, and q·w_i < t2

and the loss pulls positives into the query's bucket and pushes negatives
out through the tanh relaxation K(x) = tanh(theta^T x):

  IUL = -Σ_{P+} log σ(K(w)·K(q)) - Σ_{P-} log(1 - σ(K(w)·K(q)))

Pairs carry a validity mask instead of being compacted, and each side is
normalised by its valid count, as in the JAX package.

What differs from the JAX module (the functions computed do not):

* RNG.  :func:`iul_train_epoch` takes the ``[n_batches, bsz]`` order of
  the rows instead of a key; :class:`IULState` holds a ``torch.Generator``
  (advanced in place), from which :func:`iul_refit_epoch` draws the order.
* ``lax.scan`` is a Python loop, and the jitted epoch and rebuild are
  plain calls.
* An epoch gathers each mined batch's pair rows, and normalises them and
  the queries (``simhash.unit``), once, not on every inner step (the same
  values), so :func:`collision_prob` takes the gathered rows
  ``w_aug[pairs.pos_w]`` and ``w_aug[pairs.neg_w]`` instead of ``w_aug``.
* The θ gradient comes from autograd; the functions that train enable it
  themselves, so they also run under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import simhash
from repro_torch.core.lss import (LSSConfig, LSSIndex, build_index,
                                  label_recall, retrieve,
                                  sparse_logits_gather)
from repro_torch.optim.adamw import adamw_init, adamw_update

__all__ = ["MinedPairs", "mine_pairs", "calibrate_thresholds", "iul_loss",
           "iul_loss_and_grad", "iul_train_epoch", "fit_lss",
           "collision_prob", "IULState", "iul_init", "iul_refit_epoch",
           "calib_recall"]


class MinedPairs(NamedTuple):
    """Static-shape pair batch.  w-ids index the WOL; masks mark validity."""

    pos_w: torch.Tensor     # int32 [B, NL]  label neuron ids (0 if invalid)
    pos_mask: torch.Tensor  # bool  [B, NL]
    neg_w: torch.Tensor     # int32 [B, C]   retrieved non-label ids
    neg_mask: torch.Tensor  # bool  [B, C]


def calibrate_thresholds(q_aug: torch.Tensor, w_aug: torch.Tensor,
                         labels: torch.Tensor, cfg: LSSConfig
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Data-driven t1/t2: t1 is a low quantile of the label inner
    products, t2 a high quantile of the inner products with every 1/512th
    neuron, clamped below ``t1 - 1e-6`` (the paper requires t1 > t2).

    ``torch.quantile`` takes at most 2^24 elements: ``[N, ~512]`` inner
    products allow N up to ~32,000 calibration queries."""
    lab_ip = torch.einsum("bd,bld->bl", q_aug,
                          w_aug[labels.clamp(min=0).long()])
    lab_ip = torch.where(labels >= 0, lab_ip,
                         torch.full_like(lab_ip, float("nan")))
    t1 = torch.nanquantile(lab_ip, cfg.t1_quantile)
    all_ip = q_aug @ w_aug[:: max(1, w_aug.shape[0] // 512)].T
    t2 = torch.quantile(all_ip, cfg.t2_quantile)
    return t1, torch.minimum(t2, t1 - 1e-6)


def mine_pairs(q_aug: torch.Tensor, labels: torch.Tensor,
               w_aug: torch.Tensor, index: LSSIndex, t1: torch.Tensor,
               t2: torch.Tensor) -> MinedPairs:
    """Algorithm 1 lines 3-11, batched and static-shape.

    labels: int32 ``[B, NL]`` padded with -1.
    """
    cand_ids, _ = retrieve(q_aug, index)                     # [B, C]
    # positives: labels NOT in S with inner product > t1
    in_set = (labels[:, :, None] == cand_ids[:, None, :]).any(-1)
    lab_ip = torch.einsum("bd,bld->bl", q_aug.float(),
                          w_aug[labels.clamp(min=0).long()].float())
    pos_mask = (labels >= 0) & ~in_set & (lab_ip > t1)
    # negatives: retrieved non-labels with inner product < t2
    is_label = (cand_ids[:, :, None] == labels[:, None, :]).any(-1)
    cand_ip = sparse_logits_gather(q_aug, w_aug, cand_ids)
    neg_mask = (cand_ids >= 0) & ~is_label & (cand_ip < t2)
    return MinedPairs(labels.clamp(min=0), pos_mask, cand_ids.clamp(min=0),
                      neg_mask)


def _pair_loss(theta: torch.Tensor, u_q: torch.Tensor, u_pos: torch.Tensor,
               u_neg: torch.Tensor, pairs: MinedPairs) -> torch.Tensor:
    """:func:`iul_loss` on the unit rows ``unit(q_aug)``,
    ``unit(w_aug[pairs.pos_w])`` and ``unit(w_aug[pairs.neg_w])``, made by
    the caller (they do not depend on theta, so an epoch makes them once a
    batch, not once an inner step)."""
    def codes(u):                       # simhash.soft_codes after its unit
        return torch.tanh(u @ theta.float())
    kq = codes(u_q)                                          # [B, KL]
    kw_pos = codes(u_pos)                                    # [B, NL, KL]
    kw_neg = codes(u_neg)                                    # [B, C, KL]
    ip_pos = torch.einsum("bk,blk->bl", kq, kw_pos)
    ip_neg = torch.einsum("bk,bck->bc", kq, kw_neg)
    # -log σ(x) = -logsigmoid(x); -log(1-σ(x)) = -logsigmoid(-x)
    pos_terms = -F.logsigmoid(ip_pos) * pairs.pos_mask
    neg_terms = -F.logsigmoid(-ip_neg) * pairs.neg_mask
    n_pos = pairs.pos_mask.sum().clamp(min=1)
    n_neg = pairs.neg_mask.sum().clamp(min=1)
    # balance: each side contributes its mean
    return pos_terms.sum() / n_pos + neg_terms.sum() / n_neg


def _value_and_grad(loss_fn, theta: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``loss_fn(theta)`` and its gradient in theta, also under
    ``torch.no_grad()``."""
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        loss = loss_fn(th)
        (grad,) = torch.autograd.grad(loss, th)
    return loss.detach(), grad


def iul_loss(theta: torch.Tensor, q_aug: torch.Tensor, w_aug: torch.Tensor,
             pairs: MinedPairs) -> torch.Tensor:
    """Balanced IUL (paper eq. 1), log σ via ``logsigmoid`` for stability."""
    unit = simhash.unit
    return _pair_loss(theta, unit(q_aug), unit(w_aug[pairs.pos_w.long()]),
                      unit(w_aug[pairs.neg_w.long()]), pairs)


def iul_loss_and_grad(theta: torch.Tensor, q_aug: torch.Tensor,
                      w_aug: torch.Tensor, pairs: MinedPairs
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(iul_loss, its gradient in theta)`` — ``jax.value_and_grad`` of
    :func:`iul_loss`; works under ``torch.no_grad()`` too."""
    return _value_and_grad(lambda th: iul_loss(th, q_aug, w_aug, pairs),
                           theta)


def collision_prob(theta: torch.Tensor, q_aug: torch.Tensor,
                   w_pos: torch.Tensor, w_neg: torch.Tensor,
                   pairs: MinedPairs, k_bits: int, n_tables: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fig-2 metric: P(all K bits of a table collide) for pos / neg pairs,
    on the pair rows ``w_aug[pairs.pos_w]`` and ``w_aug[pairs.neg_w]``."""
    def table_collide(x, y):     # [..., KL] bool each (broadcastable)
        eq = x == y
        eq = eq.reshape(eq.shape[:-1] + (n_tables, k_bits))
        return eq.all(-1).float().mean(-1)                   # [...] over L
    bq = simhash.hash_bits(q_aug, theta)                     # [B, KL]
    cp = table_collide(bq[:, None, :], simhash.hash_bits(w_pos, theta))
    cn = table_collide(bq[:, None, :], simhash.hash_bits(w_neg, theta))
    p_pos = (cp * pairs.pos_mask).sum() / pairs.pos_mask.sum().clamp(min=1)
    p_neg = (cn * pairs.neg_mask).sum() / pairs.neg_mask.sum().clamp(min=1)
    return p_pos, p_neg


def iul_train_epoch(theta: torch.Tensor, opt_state, q_aug_all: torch.Tensor,
                    labels_all: torch.Tensor, w_aug: torch.Tensor,
                    index: LSSIndex, t1: torch.Tensor, t2: torch.Tensor,
                    cfg: LSSConfig, order: torch.Tensor):
    """One epoch: mine each batch against the frozen epoch ``index``, then
    ``cfg.iul_inner_steps`` Adam steps on θ.

    ``order``: int ``[n_batches, bsz]`` rows of ``q_aug_all``, one batch
    per row (:func:`iul_refit_epoch` draws it at random).  Returns
    ``(theta, opt_state, (losses, p_collide_pos, p_collide_neg))``, each
    of the three ``[n_batches]``: the loss at the batch's last inner
    step, and the collision probabilities after it.
    """
    losses, cps, cns = [], [], []
    for idx in order.to(q_aug_all.device).long():
        q = q_aug_all[idx]
        pairs = mine_pairs(q, labels_all[idx], w_aug, index, t1, t2)
        w_pos, w_neg = w_aug[pairs.pos_w.long()], w_aug[pairs.neg_w.long()]
        units = [simhash.unit(x) for x in (q, w_pos, w_neg)]
        for _ in range(cfg.iul_inner_steps):
            loss, g = _value_and_grad(
                lambda th: _pair_loss(th, *units, pairs), theta)
            theta, opt_state = adamw_update(g, opt_state, theta,
                                            lr=cfg.iul_lr)
        cp, cn = collision_prob(theta, q, w_pos, w_neg, pairs, cfg.k_bits,
                                cfg.n_tables)
        losses.append(loss)
        cps.append(cp)
        cns.append(cn)
    return theta, opt_state, (torch.stack(losses), torch.stack(cps),
                              torch.stack(cns))


class IULState(NamedTuple):
    """Resumable IUL training state over one calibration snapshot: the
    hyperplanes being trained, the Adam moments, the mined thresholds, and
    the generator that draws each epoch's batch order (advanced in
    place)."""

    theta: torch.Tensor
    opt_state: Any
    t1: torch.Tensor
    t2: torch.Tensor
    generator: torch.Generator


def iul_init(generator: torch.Generator, q_aug: torch.Tensor,
             labels_all: torch.Tensor, w_aug: torch.Tensor, cfg: LSSConfig,
             theta: torch.Tensor | None = None) -> IULState:
    """Seed an IUL training stream against a calibration snapshot.
    ``theta=None`` draws fresh hyperplanes from ``generator`` (the offline
    :func:`fit_lss` path); passing a serving index's theta resumes from
    it."""
    if theta is None:
        theta = simhash.init_hyperplanes(generator, w_aug.shape[1],
                                         cfg.k_bits, cfg.n_tables,
                                         device=w_aug.device)
    t1, t2 = calibrate_thresholds(q_aug, w_aug, labels_all, cfg)
    return IULState(theta, adamw_init(theta), t1, t2, generator)


def iul_refit_epoch(state: IULState, q_aug: torch.Tensor,
                    labels_all: torch.Tensor, w_aug: torch.Tensor,
                    index: LSSIndex, cfg: LSSConfig
                    ) -> tuple[IULState, LSSIndex, dict]:
    """One training epoch + rebuild against a frozen snapshot.  Mines
    against ``index`` (the previous rebuild, per Algorithm 1); returns the
    advanced state, the candidate index, and the epoch's metrics."""
    n = q_aug.shape[0]
    bsz = min(cfg.iul_batch, n)
    n_batches = n // bsz
    gen = state.generator
    perm = torch.randperm(n, generator=gen, device=gen.device)
    order = perm[: n_batches * bsz].reshape(n_batches, bsz)
    theta, opt_state, (loss, cp, cn) = iul_train_epoch(
        state.theta, state.opt_state, q_aug, labels_all, w_aug, index,
        state.t1, state.t2, cfg, order)
    new_index = build_index(w_aug, theta, cfg)
    info = {"loss": float(loss.mean()),
            "p_collide_pos": float(cp.mean()),
            "p_collide_neg": float(cn.mean()),
            "recall": calib_recall(new_index, q_aug, labels_all)}
    return state._replace(theta=theta, opt_state=opt_state), new_index, info


def calib_recall(index: LSSIndex, q_aug: torch.Tensor,
                 labels_all: torch.Tensor, n: int = 1024) -> float:
    """Calibration-set label recall of ``index`` (first ``n`` rows), the
    model-selection metric of :func:`fit_lss`."""
    cand, _ = retrieve(q_aug[: min(n, q_aug.shape[0])], index)
    return float(label_recall(cand, labels_all[: cand.shape[0]]))


def fit_lss(generator: torch.Generator, q_all: torch.Tensor,
            labels_all: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor | None, cfg: LSSConfig, verbose: bool = False
            ) -> tuple[LSSIndex, dict]:
    """Full offline preprocessing (paper Algorithm 1, iterated).

    Returns (the index of the epoch with the best calibration recall, a
    history dict of per-epoch metrics); ``verbose`` prints each epoch's.
    """
    # the WOL and the queries are data here: only theta trains
    w_aug = simhash.augment_neurons(w, b).detach()
    q_aug = simhash.augment_queries(q_all).detach()
    state = iul_init(generator, q_aug, labels_all, w_aug, cfg)
    hist = {"loss": [], "p_collide_pos": [], "p_collide_neg": [],
            "recall": []}
    index = build_index(w_aug, state.theta, cfg)
    best_index, best_rec = index, -1.0
    for ep in range(cfg.iul_epochs):
        state, index, info = iul_refit_epoch(state, q_aug, labels_all,
                                             w_aug, index, cfg)
        rec = info["recall"]
        # IUL's mining distribution shifts every rebuild, so an epoch can
        # regress: serve the best epoch's index, not the last one
        if rec > best_rec:
            best_rec, best_index = rec, index
        for k in hist:
            hist[k].append(info[k])
        if verbose:
            print(f"[iul] epoch {ep}: loss={info['loss']:.4f} "
                  f"P+collide={info['p_collide_pos']:.3f} "
                  f"P-collide={info['p_collide_neg']:.3f} recall={rec:.3f}")
    return best_index, hist
