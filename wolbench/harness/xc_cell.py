"""Driver of the ``xc`` cells: the paper's XC model served by the port's
``Engine`` (embedding bag in the step, then the cell's head), under a
``bulk`` mix.

Set-up makes the weights, theta and the pool of row batches from the
seed, builds the engine (``Engine.swap_from_theta`` builds the LSS
index) and calls the cell's one step shape twice, which captures its
CUDA graph.  In the window ``clients`` threads each send whole batches
through ``Engine.rank`` and bring the top-k home through the port's
``HostOutput``; a batch sampled from the seed keeps its answers.  After
the window the program is freed and the kept answers are held against
the plain reference; a control run (``control=True``) also holds the
reference computed with TF32 against it.
"""

from __future__ import annotations

import gc
import threading
import time

import numpy as np
import torch

from wolbench.harness import weights
from wolbench.harness.profiling import Profiled
from wolbench.harness.window import bulk_window
from wolbench.reference import common, heads, judge
from wolbench.reference import xc as ref_xc
from wolbench.traffic import generator as gen

__all__ = ["run"]

MAX_ITERS = 1 << 18       # batches a client may send in one window
JOIN_S = 120.0            # a client's last call may end this long after


class XCContext:
    """What the cell's metric readers read."""

    kind = "xc"

    def __init__(self, cfg, mix, head, pool, params, theta, device):
        self.cfg, self.mix, self.head = cfg, mix, head
        self.pool, self.params, self.theta = pool, params, theta
        self.device = device
        self.window = None             # (t0, t1)
        self.prof = None               # Profiled (its window: trace)
        self.calls: list = []          # (t_sent, t_done, rows, batch)
        self._index = None
        self._facts: dict = {}

    def index(self) -> common.Index:
        if self._index is None:
            lss = self.cfg["lss"]
            self._index = common.build_index(
                self.params["w_out"], self.params["b_out"], self.theta,
                lss["k_bits"], lss["n_tables"], lss["capacity"])
        return self._index

    def facts(self, b: int) -> dict:
        """Counts of pool batch ``b``: valid and distinct features, and for
        the LSS head the reference's slabs hit and slots scored."""
        if b in self._facts:
            return self._facts[b]
        x = self.pool[b]
        valid = x >= 0
        f = {"rows": x.shape[0], "features": int(valid.sum()),
             "distinct_features": int(np.unique(x[valid]).size)}
        if self.head != "full":
            index = self.index()
            q = ref_xc.embed_bag(self.params["embed_table"],
                                 torch.from_numpy(x).to(self.device))
            bucket = common.pack(common.projections(
                common.augment(q), index.theta), index.k_bits)[:, 0]
            occ = (index.table[0] >= 0).sum(-1)             # [2^K]
            uniq = torch.unique(bucket)
            f.update(distinct_slabs=int(uniq.numel()),
                     distinct_occupied=int(occ[uniq].sum()),
                     scored=int(occ[bucket].sum()))
        self._facts[b] = f
        return f

    def calls_between(self, t0: float, t1: float) -> list:
        return [c for c in self.calls if t0 <= c[1] <= t1]


def free_program() -> None:
    """Collect what the caller dropped of the program, its CUDA graphs
    included, and hand the memory back."""
    from repro_torch.serve.step import release_graphs
    gc.collect()
    release_graphs()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, control: bool = False) -> dict:
    from repro_torch import obs
    from repro_torch.core.lss import LSSConfig
    from repro_torch.device import HostOutput
    from repro_torch.models.xc import XCConfig, XCModel
    from repro_torch.serve.engine import Engine

    cfg, mix = cell.config, cell.mix
    head = mix["head"]
    lss = cfg["lss"]
    obs.set_enabled(trace)
    params = weights.xc_weights(cfg, seed, device)
    theta = weights.hyperplanes(cfg["hidden"] + 1, lss["k_bits"],
                                lss["n_tables"], seed, device)
    pool = gen.bow_pool(mix, cfg["input_dim"], cfg["max_in"], seed)
    model = XCModel.from_params(params, XCConfig(
        cfg["name"], cfg["input_dim"], cfg["hidden"], cfg["output_dim"],
        max_in=cfg["max_in"]))
    engine = Engine(model.embed, params["w_out"], params["b_out"],
                    LSSConfig(k_bits=lss["k_bits"], n_tables=lss["n_tables"],
                              capacity=lss["capacity"],
                              slab_dtype=lss["slab_dtype"]),
                    top_k=cfg["top_k"], head=head,
                    buckets=tuple(cfg["buckets"]))
    if head != "full":
        engine.swap_from_theta(theta)

    def call(batch):
        out = engine.rank(batch, head=head, record=False)
        return HostOutput((out.logits, out.ids)).wait()

    for b in range(2):                   # the step's capture, then a replay
        call(pool[b])
    prof = Profiled(trace, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    ctx = XCContext(cfg, mix, head, pool, params, theta, device)
    clients = mix["clients"]
    rng = gen.rng_for(seed, 3)
    orders = [rng.permutation(pool.shape[0]) for _ in range(clients)]
    keep = rng.random((clients, MAX_ITERS)) < 1.0 / mix["check_every"]
    go, stop = threading.Event(), threading.Event()
    calls: list[list] = [[] for _ in range(clients)]
    kept: list = []
    failures: list = []

    def client(c: int) -> None:
        go.wait()
        for i in range(MAX_ITERS):
            if stop.is_set():
                return
            b = int(orders[c][i % len(orders[c])])
            t_sent = time.perf_counter()
            try:
                logits, ids = call(pool[b])
            except Exception as exc:       # a failed request is counted
                failures.append((t_sent, pool.shape[1], repr(exc)))
                return
            calls[c].append((t_sent, time.perf_counter(), pool.shape[1], b))
            if keep[c, i]:
                kept.append((b, ids.copy(), logits.copy()))

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    with prof:
        t0 = prof.t0
        go.set()
        t_trace = t0 + min(mix["trace_seconds"], seconds)
        time.sleep(max(0.0, t_trace - time.perf_counter()))
        prof.stop()
        time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
    t1 = t0 + seconds
    stop.set()
    for t in threads:
        t.join(JOIN_S)
    hung = sum(t.is_alive() for t in threads)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    ctx.window, ctx.prof = (t0, t1), prof
    ctx.calls = sorted(c for cs in calls for c in cs)
    prof.reduce()
    e2e = bulk_window([c[:3] for c in ctx.calls], t0, t1)
    attempted = sum(c[2] for c in ctx.calls if t0 <= c[0] <= t1) \
        + sum(f[1] for f in failures)
    failed = sum(f[1] for f in failures) + hung * pool.shape[1]

    del engine, model, call
    free_program()
    checks, control_checks = _judge(ctx, kept, control)
    return {"setup_s": setup_s, "e2e": {"queries_per_s": e2e["queries_per_s"]},
            "attempted": attempted, "failed": failed,
            "failures": [f[2] for f in failures[:3]],
            "peak_bytes": peak, "checks": checks,
            "control_checks": control_checks, "ctx": ctx,
            "compared": len(kept)}


def _judge(ctx: XCContext, kept: list, control: bool):
    """Every kept batch against the reference (and the control's answers
    for the same batches).  Neurons are hashed with their bias and
    queries with a zero, so an LSS logit is ``q . w``: the LSS head's
    scores carry no bias, the full head's do."""
    cfg, dev = ctx.cfg, ctx.device
    w, b = ctx.params["w_out"], ctx.params["b_out"]
    k = cfg["top_k"]
    parts, ctrl = [], []
    with common.no_tf32(), torch.no_grad():
        index = ctx.index() if ctx.head != "full" else None
        for bi, ids, logits in kept:
            x = torch.from_numpy(ctx.pool[bi]).to(dev)
            q = ref_xc.embed_bag(ctx.params["embed_table"], x)
            ids_t, lg_t = torch.from_numpy(ids), torch.from_numpy(logits)
            if index is not None:
                parts.append(judge.judge_lss(q, index, w, None, ids_t, lg_t))
            else:
                parts.append(judge.judge_full(q, w, b, ids_t, lg_t))
            if not control:
                continue
            q32 = ref_xc.embed_bag(ctx.params["embed_table"], x,
                                   dtype=torch.float32)
            if index is not None:
                c_lg, c_ids = heads.lss_topk(q32, index, w, None, k,
                                             precision="tf32")
                ctrl.append(judge.judge_lss(q, index, w, None, c_ids,
                                            c_lg.float()))
            else:
                c_lg, c_ids = heads.full_topk(q32, w, b, k, precision="tf32")
                ctrl.append(judge.judge_full(q, w, b, c_ids, c_lg.float()))
    return judge.merge(parts), (judge.merge(ctrl) if control else None)
