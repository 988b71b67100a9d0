"""Training launcher (counterpart of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 200 \\
        --ckpt-dir /tmp/ckpt [--devices 2 --mesh 1x2] [--reduced] \\
        [--device cpu]

Trains an LM arch on the synthetic LM stream with the port's trainer:
checkpoints every 50 steps and at the end, and auto-resumes from the
newest valid checkpoint in ``--ckpt-dir``, onto whatever mesh is current
(a checkpoint saved on one mesh resumes on another, or on one device).
A rerun on a finished directory resumes at its last step and says so (it
trains nothing).

``--mesh DxM`` trains on a (data, model) mesh of D*M ranks with the
model's ``param_specs``.  Torch cannot fake devices inside one process
as XLA does, so ``--devices N`` starts N ranks of this launcher on this
machine (over ``REPRO_DIST_COORDINATOR``, ``_NUM_PROCESSES`` and
``_PROCESS_ID``) and waits for them: on the CPU they are gloo ranks
(each with ``cpu_count // N`` intra-op threads unless
``OMP_NUM_THREADS`` says otherwise); on the card each rank takes a card
of its own, and ranks beyond the cards share one over gloo (NCCL refuses
two ranks on one GPU; the backend is chosen as the serving fleet's is).
Without ``--devices``, ``--mesh`` joins the fleet those variables
describe, one launcher a rank.  Only rank 0 prints.
"""

from __future__ import annotations

import argparse
import math
import multiprocessing as mp
import os
import socket
import sys
import time

import torch

from repro_torch.configs.reduced import reduced_model_cfg
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import ShardedBatchIterator
from repro_torch.data.synthetic import lm_dataset
from repro_torch.device import resolve_device
from repro_torch.distributed import (DIST_COORDINATOR_ENV,
                                     DIST_NUM_PROCESSES_ENV,
                                     DIST_PROCESS_ID_ENV, init_distributed,
                                     make_training_mesh, process_count,
                                     shutdown_distributed)
from repro_torch.models import transformer as T
from repro_torch.train.trainer import TrainConfig, Trainer

__all__ = ["main"]

#: how long a rank may take to report back to the ``--devices`` parent
RANK_TIMEOUT_S = 3600.0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--devices", type=int, default=0,
                    help="start this many local ranks (gloo on the CPU, a "
                         "card a rank, ranks sharing a card over gloo)")
    ap.add_argument("--mesh", default="", help="e.g. 1x2 (data x model)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def _mesh_shape(text: str) -> tuple[int, ...]:
    try:
        shape = tuple(int(x) for x in text.split("x"))
    except ValueError:
        shape = ()
    if not 1 <= len(shape) <= 2 or min(shape) < 1:
        sys.exit(f"train: --mesh {text!r} is not DxM (data x model)")
    return shape


def main(argv: list[str] | None = None) -> dict:
    """Train; returns ``step`` (the state's step at the end), ``resumed``
    (whether a checkpoint was restored), ``history`` (the trainer's
    logged steps, empty when nothing was left to train) and ``loss``
    (the last logged loss, or None).  With ``--devices`` these are rank
    0's, and ``seconds`` the ranks' wall time."""
    args = _parser().parse_args(argv)
    spec = get_config(args.arch)
    if spec.family != "lm":
        print(f"this launcher trains LM archs; {args.arch} is a "
              f"{spec.family} model")
        sys.exit(2)
    shape = _mesh_shape(args.mesh) if args.mesh else None
    if args.devices:
        if shape is None or args.devices != math.prod(shape):
            sys.exit(f"train: --devices {args.devices} starts that many "
                     f"ranks; give --mesh DxM with D*M = {args.devices}")
        return _spawn(argv if argv is not None else sys.argv[1:], args)
    if shape is not None:
        if not init_distributed(device=args.device):
            sys.exit(f"train: --mesh {args.mesh} needs its ranks: give "
                     f"--devices N, or start one launcher a rank with "
                     f"{DIST_COORDINATOR_ENV}, {DIST_NUM_PROCESSES_ENV} "
                     f"and {DIST_PROCESS_ID_ENV}")
        try:
            return _train(args, shape)
        finally:
            shutdown_distributed()
    return _train(args, None)


def _train(args, shape) -> dict:
    spec = get_config(args.arch)
    # the launcher's batches fit without rematerialising: each layer's
    # forward runs once (the cells of launch.steps keep JAX's remat)
    cfg = (reduced_model_cfg(args.arch) if args.reduced
           else spec.model_cfg)._replace(remat=False)
    mesh = param_specs = None
    if shape is not None:
        axes = ("data", "model")[:len(shape)]
        tm = make_training_mesh(shape, axes)
        mesh, dev = tm.mesh, tm.device
        param_specs = T.param_specs(cfg)
        print(f"mesh: {'x'.join(map(str, shape))} ({' x '.join(axes)}) "
              f"over {process_count()} ranks, backend {tm.backend}, {dev}")
    else:
        dev = resolve_device(args.device)

    toks = lm_dataset(0, args.batch * args.seq * 64, cfg.vocab,
                      args.seq + 1)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tc = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                     total_steps=args.steps, ckpt_every=50)
    tr = Trainer(lambda p, b: T.lm_loss(p, b, cfg),
                 lambda g: T.init_params(g, cfg, device=dev), tc,
                 ckpt_dir=args.ckpt_dir, device=dev, mesh=mesh,
                 param_specs=param_specs)
    it = ShardedBatchIterator(data, args.batch, device=dev, mesh=mesh)
    t0 = time.perf_counter()
    state, hist = tr.fit(torch.Generator(dev).manual_seed(0), it,
                         args.steps)
    step = int(state.step)
    print(f"fit: {time.perf_counter() - t0:.1f} s from step "
          f"{tr.start_step}, {len(tr.save_seconds)} checkpoint saves in "
          f"{sum(tr.save_seconds):.1f} s")
    if hist:
        print(f"done: step {step} loss {hist[-1]['loss']:.4f}")
    else:
        print(f"resumed at step {step}: nothing left to train")
    return {"step": step, "resumed": tr.start_step > 0, "history": hist,
            "loss": hist[-1]["loss"] if hist else None}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(argv: list[str], rank: int, world: int, port: int,
               threads: int | None, results) -> None:
    """One rank started by ``--devices``: this launcher without the flag,
    in a fleet over the ``REPRO_DIST_COORDINATOR``-family variables."""
    os.environ.update({DIST_COORDINATOR_ENV: f"127.0.0.1:{port}",
                       DIST_NUM_PROCESSES_ENV: str(world),
                       DIST_PROCESS_ID_ENV: str(rank)})
    if threads is not None:
        torch.set_num_threads(threads)
    if rank:
        sys.stdout = open(os.devnull, "w")
    out = main(argv)
    if rank == 0:
        results.put(out)


def _without_devices(argv: list[str]) -> list[str]:
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--devices":
            skip = True
        elif not a.startswith("--devices="):
            out.append(a)
    return out


def _spawn(argv: list[str], args) -> dict:
    """Start ``args.devices`` ranks of this launcher (fresh interpreters)
    and wait for them; a rank that fails stops the others."""
    n = args.devices
    threads = None
    if resolve_device(args.device).type == "cpu" and \
            "OMP_NUM_THREADS" not in os.environ:
        threads = max(1, (os.cpu_count() or 1) // n)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    rank_argv = _without_devices(argv)
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_rank_main, args=(rank_argv, r, n, port,
                                                  threads, results))
             for r in range(n)]
    for p in procs:
        p.start()
    out, t_end = None, time.monotonic() + RANK_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs) or out is None:
            failed = [(r, p.exitcode) for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise SystemExit(f"train: rank {failed[0][0]} exited "
                                 f"{failed[0][1]}")
            if time.monotonic() > t_end:
                raise SystemExit(f"train: the ranks outlived "
                                 f"{RANK_TIMEOUT_S:.0f} s")
            if out is None:
                try:
                    out = results.get(timeout=0.2)
                except Exception:       # queue.Empty
                    if not any(p.is_alive() for p in procs):
                        raise SystemExit("train: rank 0 reported nothing")
            else:
                for p in procs:
                    p.join(timeout=0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    out["seconds"] = time.perf_counter() - t0
    return out


if __name__ == "__main__":
    main()
