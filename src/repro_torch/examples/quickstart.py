"""Quickstart (counterpart of the JAX package's ``examples/quickstart.py``):
the paper's pipeline end to end at the WIKI10 bench size.

1. Train an extreme-classification model (Embedding -> ReLU -> WOL) on
   synthetic topic-structured data (Wiki10-31k stand-in, reduced dims).
2. Fit the LSS index (Algorithm 1: mine pairs -> IUL -> rebuild).
3. Serve with the LSS head (Algorithm 2) and compare against full
   inference: accuracy, label recall, sample size, time per query.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      [--steps N] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.paper_datasets import WIKI10
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

__all__ = ["main"]


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = WIKI10.bench
    print(f"== 1. train XC model ({cfg.input_dim} -> {cfg.hidden} -> "
          f"{cfg.output_dim} WOL) on {_device_name(dev)} ==")
    data = xc_dataset(7, 3072, cfg.input_dim, cfg.output_dim, n_topics=48,
                      max_in=cfg.max_in, max_labels=cfg.max_labels)
    tc = TrainConfig(lr=5e-3, warmup_steps=30, total_steps=args.steps,
                     weight_decay=0.0, ckpt_every=10 ** 9)
    tr = Trainer(lambda p, b: xc.loss(p, b, cfg),
                 lambda g: xc.init_params(g, cfg, dev), tc, device=dev)
    it = ShardedBatchIterator({"x": data.x, "labels": data.labels}, 256,
                              device=dev)
    state, hist = tr.fit(torch.Generator(dev).manual_seed(0), it, args.steps,
                         log_every=100)

    with torch.no_grad():
        model = xc.XCModel.from_params(state.params, cfg)
        n_test = 512
        q_all = model.embed(torch.from_numpy(data.x).to(dev))
        q_tr, q_te = q_all[n_test:], q_all[:n_test]
        lab = torch.from_numpy(data.labels).to(dev)
        lab_tr, lab_te = lab[n_test:], lab[:n_test]
        w, b = model.w_out.float(), model.b_out.float()

        print("\n== 2. fit LSS (offline preprocessing, paper Alg. 1) ==")
        index, _ = fit_lss(torch.Generator(dev).manual_seed(1), q_tr, lab_tr,
                           w, b, WIKI10.bench_lss, verbose=True)

        print("\n== 3. serve: LSS vs full ==")
        heads = {"full": lambda q: topk_lowest_index(q @ w.T + b, 5)[1],
                 "lss": lambda q: lss_predict(q, index, None, top_k=5)[1]}
        ids = {name: fn(q_te) for name, fn in heads.items()}
        us = {}
        for name, fn in heads.items():
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(5):
                fn(q_te)
            _sync(dev)
            us[name] = (time.perf_counter() - t0) / 5 / n_test * 1e6
            print(f"  {name}: {us[name]:.1f} us/query ({_device_name(dev)})")
        cand, _ = retrieve(augment_queries(q_te), index)
        out = {
            "history": hist, "us_per_query": us,
            "full": {"P@1": float(precision_at_k(ids["full"], lab_te, 1)),
                     "P@5": float(precision_at_k(ids["full"], lab_te, 5))},
            "lss": {"P@1": float(precision_at_k(ids["lss"], lab_te, 1)),
                    "P@5": float(precision_at_k(ids["lss"], lab_te, 5)),
                    "label_recall": float(label_recall(cand, lab_te)),
                    "avg_sample_size": float(avg_sample_size(cand))},
        }
    print(f"  full P@1={out['full']['P@1']:.4f} P@5={out['full']['P@5']:.4f}")
    print(f"  LSS  P@1={out['lss']['P@1']:.4f} P@5={out['lss']['P@5']:.4f} "
          f"recall={out['lss']['label_recall']:.3f} "
          f"sample={out['lss']['avg_sample_size']:.0f}/{cfg.output_dim}")
    return out


if __name__ == "__main__":
    main()
