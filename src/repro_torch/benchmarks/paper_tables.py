"""The paper's experiments: Table 1, Table 2 and Fig. 2 (counterpart of
the JAX package's ``benchmarks/paper_tables.py``).

Pipeline per dataset, as the paper's: train the model on synthetic
topic-structured data at bench scale -> freeze -> fit LSS on TRAIN
embeddings -> evaluate every method on TEST.  As in the JAX package, the
"test" rows of the XC settings are rows the model trained on
(:func:`_train_xc` trains on all ``n_train`` rows).  :func:`eval_methods`
is the evaluation half of :func:`run_setting` on its own, so that it can
also score a model and an index trained elsewhere.

Metrics: P@1, P@5, label recall, sample size, microseconds per query
(host clock around calls that end in a synchronise of the card) and an
energy proxy, MFLOP per query.  ``BENCH_FAST=0`` runs the full-pass sizes
(fast is the default).  Entry points run on the GPU unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.benchmarks import baselines as B
from repro_torch.configs.paper_datasets import ALL as SETTINGS
from repro_torch.core import simhash
from repro_torch.core.iul import fit_lss
from repro_torch.core.lss import (LSSConfig, LSSIndex, avg_sample_size,
                                  label_recall, lss_predict, precision_at_k,
                                  retrieve)
from repro_torch.data.pipeline import ShardedBatchIterator
from repro_torch.data.synthetic import lm_dataset, xc_dataset
from repro_torch.device import resolve_device
from repro_torch.models import lstm as lstm_mod
from repro_torch.models import xc as xc_mod
from repro_torch.train.trainer import TrainConfig, Trainer
from repro_torch.utils.tree import tree_leaves

__all__ = ["FAST", "Row", "eval_methods", "run_setting", "table2_kl_sweep",
           "fig2_collision_curves"]

# fast is the default across benchmarks; BENCH_FAST=0 runs full size
FAST = os.environ.get("BENCH_FAST", "1") != "0"


class Row(NamedTuple):
    dataset: str
    method: str
    p1: float
    p5: float
    recall: float
    sample: float
    us_per_query: float
    mflop_per_query: float


def _sync(out) -> None:
    """Wait for the card where ``out`` lives there (JAX's
    ``block_until_ready``)."""
    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def _timeit(fn, *args, n_queries: int, reps: int = 3) -> float:
    _sync(fn(*args))                                       # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        _sync(fn(*args))
    return (time.perf_counter() - t0) / reps / n_queries * 1e6


def _gen(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(dev).manual_seed(seed)


def _train_xc(setting, n_train=4096, steps=600, device=None):
    dev = resolve_device(device)
    cfg = setting.bench
    data = xc_dataset(7, n_train, cfg.input_dim, cfg.output_dim,
                      n_topics=48, max_in=cfg.max_in,
                      max_labels=cfg.max_labels)
    tc = TrainConfig(lr=5e-3, warmup_steps=30, total_steps=steps,
                     weight_decay=0.0, ckpt_every=10 ** 9)
    tr = Trainer(lambda p, b: xc_mod.loss(p, b, cfg),
                 lambda g: xc_mod.init_params(g, cfg, dev), tc, device=dev)
    it = ShardedBatchIterator({"x": data.x, "labels": data.labels}, 256,
                              seed=0, device=dev)
    state, _ = tr.fit(_gen(dev, 0), it, steps, log_every=10 ** 9)
    params = state.params
    n_test = min(1024, n_train // 4)
    q_all = xc_mod.XCModel.from_params(params, cfg).embed(
        torch.from_numpy(data.x).to(dev))
    lab = torch.from_numpy(data.labels).to(dev)
    return params, cfg, q_all[n_test:], lab[n_test:], q_all[:n_test], \
        lab[:n_test]


def _train_lstm(setting, steps=200, device=None):
    dev = resolve_device(device)
    cfg = setting.bench
    toks = lm_dataset(3, 120_000 if not FAST else 30_000, cfg.vocab, 36)
    tokens, labels = toks[:, :-1], toks[:, 1:]
    tc = TrainConfig(lr=5e-3, warmup_steps=30, total_steps=steps,
                     weight_decay=0.0, ckpt_every=10 ** 9)
    tr = Trainer(lambda p, b: lstm_mod.loss(p, b, cfg),
                 lambda g: lstm_mod.init_params(g, cfg, dev), tc, device=dev)
    it = ShardedBatchIterator({"tokens": tokens, "labels": labels}, 64,
                              seed=0, device=dev)
    state, _ = tr.fit(_gen(dev, 0), it, steps, log_every=10 ** 9)
    params = state.params
    h = lstm_mod.embed_seq(
        params, torch.from_numpy(np.ascontiguousarray(tokens[:96])).to(dev),
        cfg)
    q = h.reshape(-1, cfg.hidden)
    lab = torch.from_numpy(np.ascontiguousarray(labels[:96])).to(dev)
    lab = lab.reshape(-1, 1)
    n_test = 1024
    return params, cfg, q[n_test:4096], lab[n_test:4096], \
        q[:n_test], lab[:n_test]


def _recall(ids: torch.Tensor, lab: torch.Tensor) -> float:
    """The share of true labels among the top-k ids."""
    hit = (ids[:, :, None] == lab[:, None, :]) & (lab >= 0)[:, None, :]
    return float(hit.any(1).sum() / (lab >= 0).sum().clamp(min=1))


def _eval_common(name, ids_fn, q_test, lab_test, d, k=5):
    ids, scored = ids_fn()
    us = _timeit(lambda: ids_fn()[0], n_queries=q_test.shape[0])
    p1 = float(precision_at_k(ids, lab_test, 1))
    p5 = float(precision_at_k(ids, lab_test, 5))
    mflop = 2 * scored * d / 1e6
    return p1, p5, _recall(ids, lab_test), scored, us, mflop


@torch.no_grad()
def eval_methods(name: str, lss_cfg: LSSConfig, w: torch.Tensor,
                 b: torch.Tensor, q_te: torch.Tensor, lab_te: torch.Tensor,
                 *, train: tuple[torch.Tensor, torch.Tensor] | None = None,
                 index: LSSIndex | None = None
                 ) -> tuple[list[Row], LSSIndex, dict | None]:
    """Table 1's five rows (Full, LSS, SLIDE, PQ, ip-NSW) for the WOL
    ``(w, b)`` on the test queries: the evaluation half of
    :func:`run_setting`.  LSS fits its index with ``lss_cfg`` on the
    training queries and labels ``train``, or takes ``index`` (a model and
    index trained elsewhere, with ``lss_cfg``'s K and L): exactly one of
    the two.  SLIDE takes the same K and L.  Returns the rows, the LSS
    index and ``fit_lss``'s history (None when ``index`` was given)."""
    if (train is None) == (index is None):
        raise ValueError("eval_methods takes exactly one of train and index")
    dev = w.device
    d, m = w.shape[1], w.shape[0]
    rows = []
    nq = q_te.shape[0]

    # FULL
    def full(q):
        return B.full_topk(q, w, b, 5)[0]

    ids = full(q_te)
    us = _timeit(full, q_te, n_queries=nq)
    rows.append(Row(name, "Full", float(precision_at_k(ids, lab_te, 1)),
                    float(precision_at_k(ids, lab_te, 5)), 1.0, m, us,
                    2 * m * d / 1e6))

    # LSS (paper)
    hist = None
    if index is None:
        index, hist = fit_lss(_gen(dev, 1), *train, w, b, lss_cfg)

    def lss_fn(q):
        return lss_predict(q, index, None, top_k=5)[1]

    cand, _ = retrieve(simhash.augment_queries(q_te), index)
    sample = float(avg_sample_size(cand))
    ids = lss_fn(q_te)
    us = _timeit(lss_fn, q_te, n_queries=nq)
    kl = lss_cfg.k_bits * lss_cfg.n_tables
    rows.append(Row(name, "LSS", float(precision_at_k(ids, lab_te, 1)),
                    float(precision_at_k(ids, lab_te, 5)),
                    float(label_recall(cand, lab_te)), sample, us,
                    2 * (d * kl + sample * d) / 1e6))

    # SLIDE (random simhash)
    sl_index = B.slide_build(_gen(dev, 2), w, b, lss_cfg)

    def sl_fn(q):
        return lss_predict(q, sl_index, None, top_k=5)[1]

    cand0, _ = retrieve(simhash.augment_queries(q_te), sl_index)
    sample0 = float(avg_sample_size(cand0))
    ids = sl_fn(q_te)
    us = _timeit(sl_fn, q_te, n_queries=nq)
    rows.append(Row(name, "SLIDE", float(precision_at_k(ids, lab_te, 1)),
                    float(precision_at_k(ids, lab_te, 5)),
                    float(label_recall(cand0, lab_te)), sample0, us,
                    2 * (d * kl + sample0 * d) / 1e6))

    # PQ
    pq = B.pq_build(_gen(dev, 3), w, b, n_subspaces=8,
                    n_iters=6 if FAST else 12)

    def pq_fn(q):
        return B.pq_topk(q, pq, 5)[0]

    ids = pq_fn(q_te)
    us = _timeit(pq_fn, q_te, n_queries=nq)
    rows.append(Row(name, "PQ", float(precision_at_k(ids, lab_te, 1)),
                    float(precision_at_k(ids, lab_te, 5)),
                    _recall(ids, lab_te), m, us, (2 * d * 256 + m * 8) / 1e6))

    # ip-NSW
    nsw = B.ipnsw_build(_gen(dev, 4), w, b)

    def nsw_fn(q):
        return B.ipnsw_topk(q, nsw, 5)[0]

    ids = nsw_fn(q_te)
    visited = B.ipnsw_topk(q_te[:1], nsw, 5)[1]
    us = _timeit(nsw_fn, q_te, n_queries=nq)
    rows.append(Row(name, "ip-NSW", float(precision_at_k(ids, lab_te, 1)),
                    float(precision_at_k(ids, lab_te, 5)),
                    _recall(ids, lab_te), float(visited), us,
                    2 * visited * d / 1e6))
    return rows, index, hist


@torch.no_grad()
def run_setting(name: str, steps=None, device=None,
                on_setting: Callable | None = None) -> list[Row]:
    """Paper Table 1 for one setting: train, fit LSS, evaluate the five
    methods.  ``on_setting(rows, index, q_test, train_seconds)`` is called
    at the end with the rows, the fitted LSS index, the test queries and
    the host seconds of the training stage (data, training steps, query
    embeddings, to the card's synchronise)."""
    setting = SETTINGS[name]
    fast_steps = 150 if FAST else 600
    t0 = time.perf_counter()
    if setting.kind == "lstm":
        params, cfg, q_tr, lab_tr, q_te, lab_te = _train_lstm(
            setting, steps or (60 if FAST else 200), device)
    else:
        params, cfg, q_tr, lab_tr, q_te, lab_te = _train_xc(
            setting, n_train=2048 if FAST else 4096,
            steps=steps or fast_steps, device=device)
    _sync(q_te)
    train_seconds = time.perf_counter() - t0
    w = params["w_out"].float()
    b = params["b_out"].float()
    rows, index, _ = eval_methods(name, setting.bench_lss, w, b, q_te,
                                  lab_te, train=(q_tr, lab_tr))
    if on_setting is not None:
        on_setting(rows, index, q_te, train_seconds)
    return rows


@torch.no_grad()
def table2_kl_sweep(name="delicious-200k", device=None,
                    on_cell: Callable | None = None) -> list[dict]:
    """Paper Table 2: K x L on the Delicious stand-in.  ``on_cell(row,
    index, q_test)`` is called after each cell with its row, its fitted
    index and the test queries."""
    setting = SETTINGS[name]
    params, cfg, q_tr, lab_tr, q_te, lab_te = _train_xc(
        setting, n_train=2048 if FAST else 4096,
        steps=150 if FAST else 500, device=device)
    w = params["w_out"].float()
    b = params["b_out"].float()
    out = []
    ks = (4, 6) if FAST else (4, 6, 8)
    ls = (1, 10) if FAST else (1, 10, 50)
    for k_bits in ks:
        for n_tables in ls:
            lss_cfg = setting.bench_lss._replace(
                k_bits=k_bits, n_tables=n_tables,
                iul_epochs=4 if FAST else 8)
            index, _ = fit_lss(_gen(w.device, 1), q_tr, lab_tr, w, b,
                               lss_cfg)
            _, ids = lss_predict(q_te, index, None, top_k=5)
            cand, _ = retrieve(simhash.augment_queries(q_te), index)
            out.append({
                "K": k_bits, "L": n_tables,
                "P@1": round(float(precision_at_k(ids, lab_te, 1)), 4),
                "P@5": round(float(precision_at_k(ids, lab_te, 5)), 4),
                "sample": round(float(avg_sample_size(cand)), 1),
            })
            if on_cell is not None:
                on_cell(out[-1], index, q_te)
    return out


@torch.no_grad()
def fig2_collision_curves(name="delicious-200k", device=None) -> dict:
    setting = SETTINGS[name]
    params, cfg, q_tr, lab_tr, q_te, lab_te = _train_xc(
        setting, n_train=2048, steps=120 if FAST else 400, device=device)
    w = params["w_out"].float()
    _, hist = fit_lss(_gen(w.device, 1), q_tr, lab_tr, w,
                      params["b_out"].float(), setting.bench_lss)
    return hist
