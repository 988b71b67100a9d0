"""Serving launcher (counterpart of ``repro.launch.serve``): train an LM
briefly, fit the LSS head, then serve one of three modes:

  * ``--mode generate`` (default) — blocking batched decode through the
    unified serving engine (``--runtime async`` instead serves open-loop
    next-token SCORING traffic: Poisson arrivals at ``--qps``, optional
    ``--deadline-ms`` load shedding).
  * ``--mode decode --streams N`` — streaming decode through the
    AsyncRuntime: open-loop Poisson SESSION arrivals at ``--qps``
    sessions/s (0 = burst), N concurrent streams interleaved in one
    fused decode step, per-token TokenStream futures, TTFT/ITL stats.

Observability: ``--metrics-port P`` starts the stdlib ``/metrics``
endpoint (Prometheus text; ``/metrics.json``, ``/trace`` too — see
``repro_torch.obs.export``) BEFORE training begins, so a scraper can
watch the whole run; ``--hold-metrics S`` keeps the process (and
endpoint) alive S seconds after serving finishes.  ``--audit-rate F``
samples fraction F of LSS-served scoring requests through the online
label-recall auditor (``lss_audit_recall_at_k``; default
``$REPRO_OBS_AUDIT_RATE``).  ``--refresh-interval S`` re-learns the LSS
hash every S seconds while serving (``repro_torch.serve.refresh``) and
prints the refresher's swaps, rollbacks, failures and serving epoch at
the end.

The model and kernels run on ``--device`` (default ``cuda``; ``cpu``
runs the kernels' plain versions).  ``--impl`` names the kernel
implementation that device runs (``cuda`` on the card, ``ref`` on the
CPU) and refuses the other.

Multi-process serving: run one launcher per process with the same flags
and ``--coordinator HOST:PORT --num-processes N --process-id I`` (or
the ``REPRO_DIST_COORDINATOR``-family variables).  Every process trains
and fits the same model from the same seeds; process 0 serves (and
refreshes the index), the others mirror its opcodes in
``serve.multihost.follower_loop``, each holding its own vocab shards of
the ``lss-sharded`` head.  The ``multihost:`` line names the backend the
fleet chose (NCCL where every rank has a device of its own, gloo where
ranks share one or on the CPU).  ``--mode decode`` is refused on a fleet
before the process group starts.

    python -m repro_torch.launch.serve --arch qwen2-0.5b --reduced \\
        --batch 16 --steps 32 [--head full|lss|lss-sharded] \\
        [--runtime async --qps 500 --deadline-ms 50] \\
        [--mode decode --streams 8 --sessions 32 --qps 0] \\
        [--metrics-port 9100 --audit-rate 0.25 --hold-metrics 30] \\
        [--refresh-interval 30] [--device cpu] \\
        [--coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs.reduced import reduced_model_cfg
from repro_torch.configs.registry import get_config
from repro_torch.core.lss import LSSConfig
from repro_torch.data.pipeline import ShardedBatchIterator
from repro_torch.data.synthetic import lm_dataset
from repro_torch.device import resolve_device
from repro_torch.distributed import (DIST_COORDINATOR_ENV,
                                     DIST_NUM_PROCESSES_ENV,
                                     shutdown_distributed)
from repro_torch.kernels import registry
from repro_torch.kernels.lss_topk.dedup import DEDUP_CHOICES
from repro_torch.kernels.lss_topk.slabs import SLAB_DTYPE_CHOICES
from repro_torch.models import transformer as T
from repro_torch.obs.audit import RecallAuditor
from repro_torch.obs.export import set_global_labels
from repro_torch.serve import AsyncRuntime, LMDecoder
from repro_torch.serve.multihost import (follower_loop, init_multihost,
                                         leader_generate, stop_followers)
from repro_torch.serve.refresh import IndexRefresher, RefreshConfig
from repro_torch.serve.runtime import (submit_decode_open_loop,
                                       submit_open_loop)
from repro_torch.train.trainer import TrainConfig, Trainer

__all__ = ["main", "serve_decode", "serve_async", "LSS_CONFIG"]

#: the launcher's own LSS fit (the JAX launcher's), not the arch's: on
#: qwen2-0.5b's 151,936-wide head, 64 buckets of P >= 2,374 neurons
LSS_CONFIG = LSSConfig(k_bits=6, n_tables=1, iul_epochs=4,
                       iul_inner_steps=8, iul_lr=0.02)


def kernel_launches() -> dict[str, int]:
    """The CUDA kernel wrappers' launch counts in this process."""
    from repro_torch.kernels.bucket_logits.ops import bucket_logits_cuda
    from repro_torch.kernels.lss_topk.ops import lss_topk_cuda
    from repro_torch.kernels.simhash_codes.ops import simhash_codes_cuda
    return {fn.__name__: fn.launches for fn in
            (simhash_codes_cuda, lss_topk_cuda, bucket_logits_cuda)}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--train-steps", type=int, default=150)
    ap.add_argument("--head", choices=("full", "lss", "lss-sharded"),
                    default="lss")
    ap.add_argument("--impl", choices=registry.IMPLS, default=None,
                    help="the kernel implementation the device runs "
                         "(cuda on the card, ref on the CPU; the other "
                         "one is refused)")
    ap.add_argument("--dedup", choices=DEDUP_CHOICES, default=None,
                    help="pin the lss_topk cross-table dedup strategy "
                         "(default: auto — quadratic below the C "
                         "crossover, bitonic above)")
    ap.add_argument("--slab-dtype", choices=SLAB_DTYPE_CHOICES,
                    default=None,
                    help="bucket-major slab storage format for the LSS "
                         "index (default: lss_topk.slab_dtype strategy / "
                         "$REPRO_LSS_SLAB_DTYPE, auto -> fp32)")
    ap.add_argument("--no-lss", action="store_true",
                    help="legacy alias for --head full")
    ap.add_argument("--mode", choices=("generate", "decode"),
                    default="generate",
                    help="generate: blocking batched decode (or scoring "
                         "with --runtime async); decode: streaming "
                         "sessions through the AsyncRuntime")
    ap.add_argument("--runtime", choices=("sync", "async"), default="sync",
                    help="sync: blocking batched decode; async: open-loop "
                         "next-token scoring through the AsyncRuntime")
    ap.add_argument("--streams", type=int, default=8,
                    help="concurrent decode streams (KV-pool slots) for "
                         "--mode decode")
    ap.add_argument("--sessions", type=int, default=None,
                    help="decode sessions to submit (default: --batch)")
    ap.add_argument("--qps", type=float, default=500.0,
                    help="offered Poisson rate: requests/s for --runtime "
                         "async, sessions/s for --mode decode "
                         "(0 = burst: everything arrives at once)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request (or per-session) deadline; "
                         "already-late work is shed, not executed")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text on "
                         "http://127.0.0.1:PORT/metrics (0 = ephemeral; "
                         "started before training)")
    ap.add_argument("--audit-rate", type=float, default=None,
                    help="online label-recall audit: fraction of "
                         "LSS-served scoring requests re-ranked through "
                         "the exact full head (default: "
                         "$REPRO_OBS_AUDIT_RATE, 0 = off)")
    ap.add_argument("--hold-metrics", type=float, default=0.0,
                    help="keep the process (and /metrics) alive this many "
                         "seconds after serving, for one-shot scrapers")
    ap.add_argument("--refresh-interval", type=float, default=None,
                    help="online index refresh: re-run IUL on the "
                         "calibration snapshot every S seconds and swap "
                         "the new index in without a serving pause "
                         "(default: off)")
    ap.add_argument("--refresh-probation", type=float, default=None,
                    help="seconds the recall auditor watches a freshly "
                         "swapped index before trusting it "
                         "($REPRO_REFRESH_PROBATION)")
    ap.add_argument("--refresh-rollback-delta", type=float, default=None,
                    help="roll the swap back if audited recall drops "
                         "more than this below the pre-swap baseline "
                         "($REPRO_REFRESH_ROLLBACK_DELTA)")
    ap.add_argument("--coordinator", default=None,
                    help="multi-process serving: the TCPStore host:port "
                         "(default: $REPRO_DIST_COORDINATOR); run one "
                         "launcher per process with the same flags, "
                         "distinct --process-id; --mode decode is not "
                         "supported on a fleet")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="multi-process serving: fleet size (default: "
                         "$REPRO_DIST_NUM_PROCESSES; <= 1 = one process)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="multi-process serving: this process's rank "
                         "(default: $REPRO_DIST_PROCESS_ID; 0 owns "
                         "admission, others mirror in follower_loop)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def _refresher(dec: LMDecoder, args) -> IndexRefresher:
    rcfg = RefreshConfig.from_env(interval_s=args.refresh_interval)
    if args.refresh_probation is not None:
        rcfg = rcfg._replace(probation_s=args.refresh_probation)
    if args.refresh_rollback_delta is not None:
        rcfg = rcfg._replace(rollback_delta=args.refresh_rollback_delta)
    print(f"index refresh: every {rcfg.interval_s}s, probation "
          f"{rcfg.probation_s}s, rollback delta {rcfg.rollback_delta}")
    return IndexRefresher(dec.engine, cfg=rcfg).start()


def main(argv: list[str] | None = None) -> dict:
    """Run the launcher; returns what it served (``mode``, the mode's
    counts and stats, ``compile_counts``, and ``refresh``: the
    refresher's counts and the epoch served at the end, or None; a
    follower's ``mode`` is ``follower`` with its op count)."""
    args = _parser().parse_args(argv)
    head = "full" if args.no_lss else args.head
    n_proc = (args.num_processes if args.num_processes is not None
              else int(os.environ.get(DIST_NUM_PROCESSES_ENV, "1")))
    coord = args.coordinator or os.environ.get(DIST_COORDINATOR_ENV)
    family = get_config(args.arch).family
    if family != "lm":
        raise SystemExit(f"serve: --arch {args.arch} is a {family} model; "
                         f"this launcher serves the LM archs")
    if args.mode == "decode" and n_proc > 1 and coord:
        # streaming decode sessions are not routed through the OP_DECODE
        # opcode channel: the leader's fused decode steps end in fleet
        # collectives the followers would never enter.  Checked BEFORE
        # the process group starts (which waits for the whole fleet) from
        # the same flag/env defaults init_multihost resolves, so every
        # process fails fast instead of hanging.
        raise SystemExit(
            "serve: --mode decode is not supported with multi-process "
            "serving (--coordinator/--num-processes): use --mode generate "
            "for blocking fleet decode, or --runtime async for open-loop "
            "scoring")
    dev = resolve_device(args.device)
    registry.resolve_impl("lss_topk", args.impl, dev)   # refuses a misfit

    server = None
    if args.metrics_port is not None:
        from repro_torch.obs.export import MetricsServer
        server = MetricsServer(port=args.metrics_port)
        print(f"metrics: {server.url}")

    ctx = init_multihost(args.coordinator, args.num_processes,
                         args.process_id, device=dev)
    if ctx is not None:
        dev = ctx.mesh.device
        set_global_labels(process=str(ctx.process_id))
        print(f"multihost: process {ctx.process_id}/{ctx.n_processes} "
              f"({'leader' if ctx.is_leader else 'follower'}), "
              f"{ctx.n_shards} vocab shards, {ctx.mesh.n_hosts} hosts x "
              f"{ctx.mesh.ranks_per_host}, backend {ctx.mesh.backend} on "
              f"{dev}", flush=True)

    spec = get_config(args.arch)
    cfg = reduced_model_cfg(args.arch) if args.reduced else spec.model_cfg
    cfg = cfg._replace(vocab=min(cfg.vocab, 4096) if args.reduced
                       else cfg.vocab, remat=False)   # 64 x 32 tokens fit

    toks = lm_dataset(0, 150_000, cfg.vocab, 33)
    tc = TrainConfig(lr=3e-3, warmup_steps=15,
                     total_steps=args.train_steps, ckpt_every=10 ** 9)
    tr = Trainer(lambda p, b: T.lm_loss(p, b, cfg),
                 lambda g: T.init_params(g, cfg, device=dev), tc,
                 device=dev)
    it = ShardedBatchIterator({"tokens": toks[:, :-1],
                               "labels": toks[:, 1:]}, 64, device=dev)
    state, _ = tr.fit(torch.Generator(dev).manual_seed(0), it,
                      args.train_steps, log_every=10 ** 9)

    refresher = None
    out: dict = {}
    try:
        with torch.no_grad(), registry.use_strategy("lss_topk.dedup",
                                                    args.dedup):
            lss_cfg = LSS_CONFIG._replace(slab_dtype=args.slab_dtype)
            # decode mode: --streams slots; generate mode: one slot per
            # prompt row so the batch decodes in a single wave.  Pool
            # width covers the warm call's 2-step floor.
            n_slots = args.streams if args.mode == "decode" else args.batch
            dec = LMDecoder(state.params, cfg, lss_cfg, max_streams=n_slots,
                            max_len=16 + max(args.steps, 2), spmd=ctx)
            if args.audit_rate is not None:
                eng = dec.engine
                if eng.auditor is not None:
                    eng.auditor.close()
                eng.auditor = (RecallAuditor(eng, args.audit_rate)
                               if args.audit_rate > 0 else None)
            if head != "full":
                dec.fit_lss(torch.Generator(dev).manual_seed(1), toks[:128])
                t = dec.index.tables
                print(f"LSS index: K={t.k_bits} L={t.n_tables} "
                      f"P={t.capacity} C={t.n_tables * t.capacity} of "
                      f"{cfg.vocab} neurons")
            prompt = toks[500:500 + args.batch, :16]
            if (args.refresh_interval is not None and head != "full"
                    and (ctx is None or ctx.is_leader)):
                refresher = _refresher(dec, args)
            if ctx is not None and not ctx.is_leader:
                # followers mirrored the (deterministic) train + fit
                # above; now replay the leader's opcodes until it stops us
                n_ops = follower_loop(dec.engine, ctx, decoder=dec)
                print(f"follower {ctx.process_id}: {n_ops} ops served")
                out = {"mode": "follower", "ops": n_ops}
            elif args.mode == "decode":
                out = serve_decode(dec, toks, head, args)
            elif args.runtime == "async":
                out = serve_async(dec, prompt, head, args)
            elif ctx is not None:
                tokens = leader_generate(ctx, dec, prompt, args.steps, head)
                print(f"decoded {tuple(tokens.shape)} tokens on "
                      f"{ctx.n_processes} processes; head={head}")
                print(tokens[:2])
                print(f"engine compiles (head, bucket): "
                      f"{dec.engine.compile_counts}")
                out = {"mode": "generate", "tokens": tokens.numpy()}
            else:
                tokens = dec.generate(prompt, steps=args.steps, head=head)
                print(f"decoded {tuple(tokens.shape)} tokens; head={head}")
                print(tokens[:2])
                print(f"engine compiles (head, bucket): "
                      f"{dec.engine.compile_counts}")
                out = {"mode": "generate", "tokens": tokens.numpy()}
            out["compile_counts"] = dict(dec.engine.compile_counts)
            if head != "full":
                t = dec.index.tables
                out["index"] = {"K": t.k_bits, "L": t.n_tables,
                                "P": t.capacity}
    finally:
        # the exporter teardown gets its own finally: a wedged close, a
        # follower-stop failure or an interrupted hold must still release
        # the /metrics port
        try:
            if refresher is not None:
                refresher.close()
                out["refresh"] = {
                    "swaps": refresher.n_refreshes,
                    "rollbacks": refresher.n_rollbacks,
                    "failures": refresher.n_failed,
                    "epoch": dec.engine.index_epoch}
                print(f"index refresh: swaps={refresher.n_refreshes} "
                      f"rollbacks={refresher.n_rollbacks} "
                      f"failures={refresher.n_failed} "
                      f"epoch={dec.engine.index_epoch}"
                      + (f" last_error={refresher.last_error}"
                         if refresher.last_error else ""))
            if ctx is not None:
                if ctx.is_leader:
                    stop_followers(ctx)
                shutdown_distributed()
            if args.hold_metrics > 0:
                print(f"holding /metrics for {args.hold_metrics}s",
                      flush=True)
                time.sleep(args.hold_metrics)
        finally:
            if server is not None:
                server.close()
    out.setdefault("refresh", None)
    out["launches"] = kernel_launches()
    print(f"kernel launches: {out['launches']}")
    return out


def serve_decode(dec: LMDecoder, toks, head: str, args) -> dict:
    """Streaming decode: open-loop decode SESSIONS through the
    AsyncRuntime at --qps sessions/s, --streams concurrent slots."""
    n_sessions = (args.sessions if args.sessions is not None
                  else args.batch)
    prompts = np.asarray(toks[500:500 + n_sessions, :16], np.int32)
    # build every step the run needs (prefill, bucket-1 first-token
    # step, fused decode step — steps >= 2, or the fused step never
    # dispatches), THEN fetch the scheduler: the warm call must not
    # outgrow and replace the pool the runtime is about to own
    dec.generate(prompts[:1], steps=2, head=head)
    sched = dec.scheduler(head=head, min_len=16 + args.steps)
    sched.reset_stats()
    deadline_s = (None if args.deadline_ms is None
                  else args.deadline_ms / 1e3)
    with AsyncRuntime(dec.engine, head=head, policy="shed",
                      default_deadline_s=deadline_s,
                      scheduler=sched, close_timeout_s=600.0) as rt:
        streams, _ = submit_decode_open_loop(
            rt, list(prompts), args.qps, max_new_tokens=args.steps, seed=0)
        rt.drain(timeout=600.0)
        s = rt.stats()
    ok = sum(st.exception(timeout=1.0) is None for st in streams)
    print(f"streaming decode: head={head} streams={args.streams} "
          f"qps={args.qps} {ok}/{len(streams)} sessions served, "
          f"{s.n_decode_tokens} tokens")
    print(f"  {s.decode_tokens_per_s:,.0f} tok/s  "
          f"ttft p50={s.ttft_p50_ms:.2f} p95={s.ttft_p95_ms:.2f} "
          f"p99={s.ttft_p99_ms:.2f} ms (incl. queue wait)")
    print(f"  itl p50={s.itl_p50_ms:.2f} p95={s.itl_p95_ms:.2f} "
          f"p99={s.itl_p99_ms:.2f} ms  "
          f"slot occupancy={s.decode_slot_occupancy:.2f}")
    print(f"  shed: queue={s.n_shed_queue} deadline={s.n_shed_deadline}")
    print(f"engine compiles (head, shape): {dec.engine.compile_counts}")
    return {"mode": "decode", "served": ok, "sessions": len(streams),
            "decode_tag": sched._tag, "stats": s._asdict()}


def serve_async(dec: LMDecoder, prompt, head: str, args) -> dict:
    """Open-loop next-token scoring: prefill once, then submit each
    sequence's final hidden state as an independent rank request through
    the AsyncRuntime at the offered QPS."""
    tokens = torch.as_tensor(np.asarray(prompt), device=dec.device)
    hidden, _ = dec.T.prefill(dec.params, tokens, dec.cfg,
                              max_len=tokens.shape[1])
    h = hidden[:, -1].float().cpu().numpy()                  # [B, d]
    reqs = np.tile(h, (max(1, args.steps), 1))               # B*steps reqs
    # build every ladder bucket the run could coalesce into (any group
    # size <= the backlog's max chunk), so the measured segment reports
    # serving latency, not build time
    batcher = dec.engine.batcher
    b_max = batcher.bucket_for(min(reqs.shape[0], batcher.max_bucket))
    for b in [b for b in batcher.buckets if b <= b_max]:
        dec.engine.rank(np.zeros((b, reqs.shape[1]), np.float32),
                        head=head, record=False)
    deadline_s = (None if args.deadline_ms is None
                  else args.deadline_ms / 1e3)
    with AsyncRuntime(dec.engine, head=head, policy="shed",
                      default_deadline_s=deadline_s,
                      close_timeout_s=300.0) as rt:
        futs, _ = submit_open_loop(rt, reqs, args.qps, seed=0)
        rt.drain(timeout=300.0)
        s = rt.stats()
    ok = sum(f.exception() is None for f in futs)
    aud = dec.engine.auditor
    audit = None
    if aud is not None:
        aud.drain()
        audit = {"recall": aud.recall, "rows": aud.n_rows, "rate": aud.rate}
        print(f"  audit recall@k={aud.recall:.4f} over {aud.n_rows} "
              f"rows (sampled at {aud.rate})")
    print(f"async runtime: head={head} qps={args.qps} "
          f"{ok}/{len(futs)} served")
    print(f"  throughput={s.throughput_rps:,.0f} rps  "
          f"p50={s.latency_p50_ms:.2f} p95={s.latency_p95_ms:.2f} "
          f"p99={s.latency_p99_ms:.2f} ms (incl. queue wait)")
    print(f"  batches={s.n_batches} occupancy={s.avg_batch_occupancy:.2f} "
          f"shed: queue={s.n_shed_queue} deadline={s.n_shed_deadline}")
    print(f"engine compiles (head, bucket): {dec.engine.compile_counts}")
    return {"mode": "async", "served": ok, "requests": len(futs),
            "audit": audit, "stats": s._asdict()}


if __name__ == "__main__":
    main()
