"""Training launcher (counterpart of ``repro.launch.train``), one device.

    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 200 \\
        --ckpt-dir /tmp/ckpt [--reduced] [--device cpu]

Trains an LM arch on the synthetic LM stream with the port's trainer:
checkpoints every 50 steps and at the end, and auto-resumes from the
newest valid checkpoint in ``--ckpt-dir``.  A rerun on a finished
directory resumes at its last step and says so (it trains nothing).
``--devices`` and ``--mesh`` (data x model sharding in the JAX launcher)
come with the port's multi-GPU slice, ROADMAP Queue 1 item 7: they exit
before any work.
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs.reduced import reduced_model_cfg
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import ShardedBatchIterator
from repro_torch.data.synthetic import lm_dataset
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.train.trainer import TrainConfig, Trainer

__all__ = ["main"]


def main(argv: list[str] | None = None) -> dict:
    """Train; returns ``step`` (the state's step at the end), ``resumed``
    (whether a checkpoint was restored), ``history`` (the trainer's
    logged steps, empty when nothing was left to train) and ``loss``
    (the last logged loss, or None)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--devices", type=int, default=0,
                    help="multi-device training: not ported yet")
    ap.add_argument("--mesh", default="",
                    help="data x model mesh: not ported yet")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.devices or args.mesh:
        sys.exit("train: --devices and --mesh (sharded training) come with "
                 "the port's multi-GPU slice (ROADMAP Queue 1 item 7); "
                 "train on one device without them")

    spec = get_config(args.arch)
    if spec.family != "lm":
        print("this launcher trains LM archs; see examples/ for others")
        sys.exit(2)
    cfg = reduced_model_cfg(args.arch) if args.reduced else spec.model_cfg
    dev = resolve_device(args.device)

    toks = lm_dataset(0, args.batch * args.seq * 64, cfg.vocab,
                      args.seq + 1)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tc = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                     total_steps=args.steps, ckpt_every=50)
    tr = Trainer(lambda p, b: T.lm_loss(p, b, cfg),
                 lambda g: T.init_params(g, cfg, device=dev), tc,
                 ckpt_dir=args.ckpt_dir, device=dev)
    it = ShardedBatchIterator(data, args.batch, device=dev)
    state, hist = tr.fit(torch.Generator(dev).manual_seed(0), it,
                         args.steps)
    step = int(state.step)
    if hist:
        print(f"done: step {step} loss {hist[-1]['loss']:.4f}")
    else:
        print(f"resumed at step {step}: nothing left to train")
    return {"step": step, "resumed": tr.start_step > 0, "history": hist,
            "loss": hist[-1]["loss"] if hist else None}


if __name__ == "__main__":
    main()
