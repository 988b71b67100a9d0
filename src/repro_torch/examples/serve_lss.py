"""Serving example (counterpart of the JAX package's
``examples/serve_lss.py``, its score and async paths): the unified engine
end to end.

1. Score path — an Engine over an XC model: requests arrive one by one
   (``submit``), the continuous micro-batcher coalesces them into
   bucketed batches, and ``metrics()`` reports latency percentiles,
   throughput, sample size and label recall from the single retrieval
   pass.
2. Async path — an Engine behind an ``AsyncRuntime``: open-loop Poisson
   traffic with per-request futures, then a burst segment, and an
   exact-equality check against the synchronous ``flush`` path.

On the card each (head, bucket) step is a captured CUDA graph; on the
CPU it runs eagerly.  The decode, streaming and vocab-sharded paths of
the JAX example come with later slices of the port.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lss [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.lss import LSSConfig
from repro_torch.data.synthetic import xc_dataset
from repro_torch.device import resolve_device
from repro_torch.models import xc
from repro_torch.serve import AsyncRuntime, Engine
from repro_torch.serve.runtime import submit_open_loop

__all__ = ["main", "score_path", "async_path"]


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


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with torch.no_grad():
        return {"score": score_path(dev), "async": async_path(dev)}


if __name__ == "__main__":
    main()
