"""Serving example (counterpart of the JAX package's
``examples/serve_lss.py``): the unified engine end to end on both request
kinds.

1. Score path — an Engine over an XC model: requests arrive one by one
   (``submit``), the continuous micro-batcher coalesces them into
   bucketed batches, and ``metrics()`` reports latency percentiles,
   throughput, sample size and label recall from the single retrieval
   pass.
2. Decode path — a small decoder-only LM (the reduced qwen2-0.5b),
   trained with ``lm_loss`` through the port's ``Trainer``, then served
   through ``LMDecoder`` (same Engine underneath): ``fit_lss`` on its LM
   head, exact vs LSS head, tokens/s and agreement.
3. Streaming decode — the same decoder behind the AsyncRuntime's decode
   request kind: sessions join/leave a fixed slot pool mid-flight,
   tokens resolve through per-token ``TokenStream`` futures, and the
   interleaved tokens are bit-identical to blocking ``generate``.
4. Async path — an Engine behind an ``AsyncRuntime``: open-loop Poisson
   traffic with per-request futures, then a burst segment, and an
   exact-equality check against the synchronous ``flush`` path.
5. Sharded path — ``head="lss-sharded"`` on this process's serving mesh,
   what one rank of a fleet builds (only its own shards), and the
   launcher recipe that runs a fleet.

On the card each (head, bucket) step and each fused decode step is a
captured CUDA graph; on the CPU they run eagerly.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lss [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.reduced import reduced_model_cfg
from repro_torch.core import simhash
from repro_torch.core.lss import LSSConfig
from repro_torch.data.pipeline import ShardedBatchIterator
from repro_torch.data.synthetic import lm_dataset, xc_dataset
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models import xc
from repro_torch.serve import AsyncRuntime, Engine, LMDecoder
from repro_torch.serve.heads import shard_index
from repro_torch.serve.runtime import (submit_decode_open_loop,
                                       submit_open_loop)
from repro_torch.train.trainer import TrainConfig, Trainer

__all__ = ["main", "score_path", "decode_path", "streaming_decode_path",
           "async_path", "sharded_multihost_path"]


def score_path(dev: torch.device) -> dict:
    print("== score path: Engine.submit / flush / metrics ==")
    cfg = xc.XCConfig("t", input_dim=2000, hidden=32, output_dim=2000,
                      max_in=16, max_labels=4)
    data = xc_dataset(0, 1024, cfg.input_dim, cfg.output_dim, n_topics=16,
                      max_in=16, max_labels=4)
    model = xc.XCModel(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    eng = Engine(lambda b: model.embed(b["x"]), model.w_out, model.b_out,
                 LSSConfig(k_bits=5, n_tables=2, iul_epochs=3,
                           iul_inner_steps=6, iul_lr=0.02),
                 top_k=5, head="lss")
    calib = [{"x": torch.from_numpy(data.x[i * 128:(i + 1) * 128]).to(dev)}
             for i in range(4)]
    eng.fit(torch.Generator(dev).manual_seed(1), calib,
            torch.from_numpy(data.labels[:512]).to(dev))

    # requests trickle in with a ragged arrival pattern
    rng = np.random.default_rng(0)
    i = 512
    while i < 1024:
        n = int(rng.integers(1, 48))
        for j in range(i, min(i + n, 1024)):
            eng.submit({"x": data.x[j]}, labels=data.labels[j])
        eng.flush()
        i += n
    m = eng.metrics()
    print(f"  {m.n_requests} requests, {m.throughput_rps:,.0f} req/s, "
          f"p50={m.latency_p50_ms:.2f}ms p99={m.latency_p99_ms:.2f}ms")
    print(f"  sample size {m.avg_sample_size:.0f}/{cfg.output_dim}, "
          f"label recall {m.label_recall:.3f}, "
          f"{m.n_compiles} builds for buckets "
          f"{sorted({k[1] for k in eng.compile_counts})}")
    return m._asdict()


def decode_path(dev: torch.device, train_steps: int
                ) -> tuple[LMDecoder, np.ndarray, dict]:
    print("== decode path: LMDecoder on the same Engine ==")
    cfg = reduced_model_cfg("qwen2-0.5b")._replace(vocab=2048, remat=False)
    toks = lm_dataset(5, 200_000, cfg.vocab, 33)
    tc = TrainConfig(lr=3e-3, warmup_steps=20, total_steps=train_steps,
                     ckpt_every=10 ** 9)
    tr = Trainer(lambda p, b: T.lm_loss(p, b, cfg),
                 lambda g: T.init_params(g, cfg, device=dev), tc,
                 device=dev)
    it = ShardedBatchIterator({"tokens": toks[:, :-1],
                               "labels": toks[:, 1:]}, 64, device=dev)
    state, hist = tr.fit(torch.Generator(dev).manual_seed(0), it,
                         train_steps, log_every=max(train_steps // 3, 1))
    print(f"  LM trained: loss {hist[-1]['loss']:.3f} "
          f"(uniform={np.log(cfg.vocab):.3f})")

    dec = LMDecoder(state.params, cfg,
                    LSSConfig(k_bits=6, n_tables=1, iul_epochs=4,
                              iul_inner_steps=8, iul_lr=0.02),
                    max_streams=16)      # one slot per prompt row below
    print("  fitting LSS index on the LM head...")
    dec.fit_lss(torch.Generator(dev).manual_seed(1), toks[:64],
                verbose=True)

    prompt = toks[1000:1016, :16]
    outs, tps = {}, {}
    for head in ("full", "lss"):
        dec.generate(prompt, steps=32, head=head)           # builds
        t0 = time.perf_counter()
        outs[head] = dec.generate(prompt, steps=32, head=head)
        tps[head] = prompt.shape[0] * 32 / (time.perf_counter() - t0)
        print(f"  {head:4s} head: {tps[head]:,.0f} tok/s")
    agree = float((outs["lss"] == outs["full"]).float().mean())
    print(f"  top-1 agreement LSS vs full: {agree:.3f}")
    return dec, toks, {"loss": hist[-1]["loss"], "tokens_per_s": tps,
                       "agreement": agree}


def streaming_decode_path(dec: LMDecoder, toks: np.ndarray) -> dict:
    print("== streaming decode: sessions + TokenStream futures ==")
    prompts = np.asarray(toks[2000:2012, :16], np.int32)
    steps = 24
    # blocking reference: one generate call per prompt (same fused step)
    blocking = [dec.generate(p[None], steps=steps, head="lss").numpy()[0]
                for p in prompts]
    sched = dec.scheduler(head="lss")
    sched.reset_stats()
    with AsyncRuntime(dec.engine, head="lss", policy="shed",
                      scheduler=sched) as rt:
        streams, _ = submit_decode_open_loop(rt, list(prompts), 50.0,
                                             max_new_tokens=steps, seed=0)
        first = list(streams[0])        # iterate tokens as they resolve
        rt.drain(timeout=300.0)
        s = rt.stats()
    exact = all(np.array_equal(st.result(timeout=60.0), blocking[i])
                for i, st in enumerate(streams))
    print(f"  {s.n_decode_done} sessions, {s.n_decode_tokens} tokens at "
          f"{s.decode_tokens_per_s:,.0f} tok/s "
          f"(slots={dec.max_streams}, occupancy "
          f"{s.decode_slot_occupancy:.2f})")
    print(f"  ttft p50={s.ttft_p50_ms:.1f} ms  "
          f"itl p50={s.itl_p50_ms:.2f} ms  "
          f"first stream: {len(first)} tokens streamed live")
    print(f"  interleaved == blocking generate: {exact}")
    return {**s._asdict(), "bit_identical": exact}


def async_path(dev: torch.device) -> dict:
    print("== async path: AsyncRuntime.submit -> futures -> stats ==")
    m, d = 4096, 32
    w = torch.randn(m, d, generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    eng = Engine(None, w, None, LSSConfig(k_bits=5, n_tables=2),
                 top_k=5, head="lss", buckets=(1, 4, 16))
    eng.fit_random(torch.Generator(dev).manual_seed(1))

    rng = np.random.default_rng(0)
    xs = rng.standard_normal((192, d)).astype(np.float32)
    # synchronous reference results for the exact-equality check
    for x in xs:
        eng.submit(x)
    sync = eng.flush()

    with AsyncRuntime(eng, max_queue=256, policy="shed") as rt:
        t0 = time.perf_counter()
        futs, _ = submit_open_loop(rt, xs[:96], 1000.0)   # paced Poisson
        burst, _ = submit_open_loop(rt, xs[96:], 0.0)     # then saturation
        futs += burst
        res = [f.result(timeout=60.0) for f in futs]
        s = rt.stats()
    exact = all(np.array_equal(r.logits, sy.logits)
                and np.array_equal(r.ids, sy.ids)
                for r, sy in zip(res, sync))
    print(f"  {s.n_completed} served in {time.perf_counter() - t0:.2f}s: "
          f"p50={s.latency_p50_ms:.2f} p95={s.latency_p95_ms:.2f} "
          f"p99={s.latency_p99_ms:.2f} ms (incl. queue wait), "
          f"occupancy={s.avg_batch_occupancy:.2f}, "
          f"shed={s.n_shed_queue}+{s.n_shed_deadline}")
    print(f"  bit-identical to synchronous flush: {exact}")
    return {**s._asdict(), "bit_identical": exact}


def sharded_multihost_path(dev: torch.device) -> dict:
    print("== vocab-sharded path: head='lss-sharded' + fleet recipe ==")
    m, d = 4096, 32
    w = torch.randn(m, d, generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    cfg = LSSConfig(k_bits=5, n_tables=2)
    eng = Engine(None, w, None, cfg, top_k=5, head="lss-sharded",
                 buckets=(16,))
    eng.fit_random(torch.Generator(dev).manual_seed(1))
    q = np.random.default_rng(3).standard_normal((16, d)).astype(np.float32)
    out, out2 = eng.rank(q), eng.rank(q)
    exact = (torch.equal(out.ids, out2.ids)
             and torch.equal(out.logits, out2.logits))
    mesh = eng._get_mesh()
    print(f"  lss-sharded over {mesh.n_shards} shard(s) on "
          f"{mesh.world} rank(s): top-{out.ids.shape[1]} of {m}, "
          f"deterministic={exact}")

    # What each FLEET member would build — only its own shards.  Here:
    # process 1 of a 2-process fleet, 2 shards a process, so shards [2, 4)
    # of 4.  No process ever holds the full [m, d] head in its index.
    w_aug = simhash.augment_neurons(w, None)
    theta = simhash.init_hyperplanes(torch.Generator(dev).manual_seed(1),
                                     d + 1, cfg.k_bits, cfg.n_tables,
                                     device=dev)
    lo, hi = 2, 4
    m_local = -(-m // 4)
    rows = (lo * m_local, min(hi * m_local, m))
    stack, _, _ = shard_index(w_aug[rows[0]:rows[1]], theta, cfg, 4,
                              shard_range=(lo, hi), m_total=m)
    print(f"  process 1/2 builds shards [{lo}, {hi}): {len(stack)} local "
          f"shard(s) over rows [{rows[0]}, {rows[1]}) — never the full "
          f"[{m}, {d}] weight")

    # The same Engine code runs a real torch.distributed fleet (gloo on
    # the CPU or where ranks share a card, NCCL across cards) — process 0
    # owns admission/results, the rest mirror via follower_loop:
    print("  scale out (one line per process):")
    for pid in range(2):
        print("    python -m repro_torch.launch.serve --arch qwen2-0.5b "
              "--reduced --head lss-sharded \\\n"
              "        --coordinator HOST0:1234 --num-processes 2 "
              f"--process-id {pid}")
    print("  (exact fleet-vs-one-process parity: "
          "tests/test_torch_multihost.py)")
    return {"n_shards": mesh.n_shards, "deterministic": exact,
            "local_shards": len(stack)}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--train-steps", type=int, default=None,
                    help="LM training steps of the decode path (default "
                         "300, as the JAX example; 150 with --device cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    steps = args.train_steps or (300 if dev.type == "cuda" else 150)
    with torch.no_grad():
        out = {"score": score_path(dev)}
        dec, toks, out["decode"] = decode_path(dev, steps)
        out["streaming"] = streaming_decode_path(dec, toks)
        out["async"] = async_path(dev)
        out["sharded"] = sharded_multihost_path(dev)
        return out


if __name__ == "__main__":
    main()
