"""End-to-end driver (counterpart of the JAX package's
``examples/train_wol.py``): train the paper's extreme-classification model
at Delicious-200K width with the trainer (checkpoints, auto-resume, LR
schedule, gradient clipping), then fit and evaluate the LSS head.

782,585-dim BoW input -> 128 hidden -> 205,443-neuron WOL
= 782585*128 + 205443*129 = ~126.7M parameters (the paper's dimensions),
trained on 6,616 synthetic samples (Delicious-200K's size in the JAX
example).  ``--fast`` drops to the bench stand-in.  P@k and recall are
measured on the first 512 training rows, as in the JAX example: they are
training-set numbers.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_wol [--fast]
      [--steps N] [--ckpt-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Callable

import torch

from repro_torch.configs.paper_datasets import DELICIOUS
from repro_torch.core.iul import fit_lss
from repro_torch.core.lss import (avg_sample_size, label_recall, lss_predict,
                                  precision_at_k, retrieve)
from repro_torch.core.simhash import augment_queries
from repro_torch.core.topk import topk_lowest_index
from repro_torch.data.pipeline import ShardedBatchIterator
from repro_torch.data.synthetic import xc_dataset
from repro_torch.device import resolve_device
from repro_torch.models import xc
from repro_torch.train.trainer import TrainConfig, Trainer

__all__ = ["run", "main"]

TOP_K = 5


def run(*, fast: bool = False, steps: int | None = None,
        ckpt_dir: str | None = None, device: str | torch.device | None = None,
        on_stage: Callable[[str], None] | None = None) -> dict:
    """Train, then ``fit_lss``, then serve the first ``n_test`` rows with
    ``lss_predict`` and with the exact full head.

    ``ckpt_dir=None`` trains without checkpoints; a directory that holds
    one resumes from it.  ``on_stage(name)`` is called after each stage
    (``train``, ``fit_lss``, ``serve``).  Returns the numbers and the
    objects made: ``history`` (the trainer's logged steps),
    ``iul_history``, ``full`` and ``lss`` (P@1, P@5; for LSS also label
    recall and average sample size), ``n_dropped``, and ``steps``,
    ``config``, ``lss_config``, ``data``, ``n_test``, ``trainer``,
    ``state``, ``model``, ``index``.
    """
    dev = resolve_device(device)
    stage = on_stage or (lambda name: None)
    cfg = DELICIOUS.bench if fast else DELICIOUS.full._replace(
        max_in=32, max_labels=4)
    steps = steps or (150 if fast else 500)
    print(f"model: {cfg.name} input={cfg.input_dim} WOL={cfg.output_dim} "
          f"params={cfg.param_count() / 1e6:.1f}M device={dev}")

    n_train = 2048 if fast else 6616     # the paper's Delicious size
    data = xc_dataset(11, n_train, cfg.input_dim, cfg.output_dim,
                      n_topics=128, max_in=cfg.max_in,
                      max_labels=cfg.max_labels)
    tc = TrainConfig(lr=5e-3, warmup_steps=30, total_steps=steps,
                     weight_decay=0.0, ckpt_every=100, keep_last=2)
    tr = Trainer(lambda p, b: xc.loss(p, b, cfg),
                 lambda g: xc.init_params(g, cfg, dev), tc,
                 ckpt_dir=ckpt_dir, device=dev)
    it = ShardedBatchIterator({"x": data.x, "labels": data.labels},
                              min(256, n_train // 4), device=dev)
    state, hist = tr.fit(torch.Generator(dev).manual_seed(0), it, steps,
                         log_every=50)
    stage("train")

    with torch.no_grad():
        # LSS head (paper Algorithm 1 on the trained model)
        model = xc.XCModel.from_params(state.params, cfg)
        n_test = min(512, n_train // 4)
        q_all = model.embed(torch.from_numpy(data.x).to(dev))
        q_tr, q_te = q_all[n_test:], q_all[:n_test]
        lab = torch.from_numpy(data.labels).to(dev)
        lss_cfg = DELICIOUS.bench_lss if fast else DELICIOUS.lss._replace(
            iul_epochs=4, iul_inner_steps=8, iul_lr=0.02)
        w, b = model.w_out.float(), model.b_out.float()
        index, iul_hist = fit_lss(torch.Generator(dev).manual_seed(1), q_tr,
                                  lab[n_test:], w, b, lss_cfg, verbose=True)
        stage("fit_lss")

        _, ids = lss_predict(q_te, index, None, top_k=TOP_K)
        cand, _ = retrieve(augment_queries(q_te), index)
        full_ids = topk_lowest_index(q_te @ w.T + b, TOP_K)[1]
        lab_te = lab[:n_test]
        out = {
            "full": {"P@1": float(precision_at_k(full_ids, lab_te, 1)),
                     "P@5": float(precision_at_k(full_ids, lab_te, 5))},
            "lss": {"P@1": float(precision_at_k(ids, lab_te, 1)),
                    "P@5": float(precision_at_k(ids, lab_te, 5)),
                    "label_recall": float(label_recall(cand, lab_te)),
                    "avg_sample_size": float(avg_sample_size(cand))},
            "n_dropped": int(index.tables.n_dropped.sum()),
        }
        stage("serve")
    print(f"full P@1={out['full']['P@1']:.4f}  "
          f"LSS P@1={out['lss']['P@1']:.4f}  "
          f"recall={out['lss']['label_recall']:.3f}  "
          f"sample={out['lss']['avg_sample_size']:.0f}/{cfg.output_dim}")
    return {**out, "history": hist, "iul_history": iul_hist, "steps": steps,
            "config": cfg, "lss_config": lss_cfg, "data": data,
            "n_test": n_test,
            "trainer": tr, "state": state, "model": model, "index": index}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="the bench stand-in (DELICIOUS.bench, 150 steps)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_wol_ckpt"),
        help="checkpoints; a run resumes from the newest one here")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = run(fast=args.fast, steps=args.steps, ckpt_dir=args.ckpt_dir,
              device=args.device)
    if res["history"]:
        print(f"trained to step {res['history'][-1]['step']}; final loss "
              f"{res['history'][-1]['loss']:.4f}")
    else:
        print(f"resumed at step {int(res['state'].step)}: nothing to train")
    return res


if __name__ == "__main__":
    main()
