"""Driver of the ``lm`` cells: a decoder served by the port's
``LMDecoder`` (paged KV, the LSS head over the tied embedding) behind
its ``AsyncRuntime``, under a ``sessions`` mix.

Set-up makes the weights, theta and the session pool from the seed,
builds the decoder, flips its engine to the index of theta
(``Engine.swap_from_theta``) and serves one short session at each
prefill width the mix's prompts use, which builds the fused decode step,
the first-token step and every prefill shape.  Then ``clients`` threads
each start a session through ``AsyncRuntime.submit_decode`` and the next
when it ends.  The window opens once every first-wave session has its
first token.  When it closes, the sessions still running are ended
(``DecodeScheduler.fail_all``), the runtime is closed and the program
freed; then a sample of the finished sessions, drawn from the seed with
the longest among them, is held against the plain reference (and, for a
control run, the reference's fp8 picks too).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from wolbench.harness import weights
from wolbench.harness.profiling import Profiled
from wolbench.harness.window import (StreamRecord, decode_window,
                                     stream_token_times)
from wolbench.harness.xc_cell import free_program
from wolbench.reference import common, heads, judge, qwen2
from wolbench.traffic import generator as gen

__all__ = ["run", "WindowClosed"]

RAMP_S = 300.0            # the first wave must be streaming within this
CLOSE_S = 60.0            # clients and runtime threads end within this


class WindowClosed(Exception):
    """How the harness ends a session still running when the window
    closes: not a failure of the program."""


class Session:
    """One session as its client saw it, read after the window."""

    def __init__(self, prompt: np.ndarray, stream):
        self.prompt = prompt
        self.tokens = stream.tokens_so_far()
        self.reason = stream.finish_reason
        self.error = stream.exception(timeout=0) if self.reason else None
        self.record = StreamRecord(stream.t_submit, stream.ttft_s(),
                                   stream.inter_token_s())

    @property
    def closed_by_harness(self) -> bool:
        from repro_torch.serve.runtime import RuntimeClosedError
        return isinstance(self.error, (WindowClosed, RuntimeClosedError))


class LMContext:
    """What the cell's metric readers read."""

    kind = "lm"

    def __init__(self, cfg, mix, params, theta, device):
        self.cfg, self.mix = cfg, mix
        self.params, self.theta, self.device = params, theta, device
        self.window = None
        self.prof = None
        self.sessions: list[Session] = []
        self.spans: list = []          # (name, t0, t1, attrs)
        self._index = None
        self._occ = None

    def index(self) -> common.Index:
        if self._index is None:
            lss = self.cfg["lss"]
            self._index = common.build_index(
                self.params["embed"], None, self.theta, lss["k_bits"],
                lss["n_tables"], lss["capacity"])
        return self._index

    def scored(self, tokens: np.ndarray) -> np.ndarray:
        """Slots the head scores for each token served: the occupancy of
        the token's bucket in the reference's index."""
        if self._occ is None:
            index = self.index()
            occ = (index.table[0] >= 0).sum(-1)
            bo = index.bucket_of[:, 0]
            self._occ = torch.where(bo >= 0, occ[bo.clamp(min=0)],
                                    occ.float().mean().round().long()
                                    ).cpu().numpy()
        return self._occ[tokens]


def _model_config(cfg: dict):
    from repro_torch.models.transformer import TransformerConfig
    return TransformerConfig(
        name=cfg["name"], n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        qkv_bias=True, qk_norm=False, rope_base=float(cfg["rope_theta"]),
        tie_embeddings=cfg["tie_word_embeddings"], dtype=torch.bfloat16)


def _spans() -> list:
    from repro_torch import obs
    out = []
    for ev in obs.trace_export(include_open=False)["traceEvents"]:
        if ev["ph"] == "X":
            t0 = ev["ts"] / 1e6
            out.append((ev["name"], t0, t0 + ev["dur"] / 1e6, ev["args"]))
    return out


def _end_sessions(rt, sched, streams: dict) -> None:
    """End every session still running, then the runtime.  A session the
    dispatcher was routing as the first pass ran is ended by the next;
    one it admitted while the runtime closed, by the last."""
    def end():
        sched.fail_all(WindowClosed("the window closed"),
                       only=lambda s: s.owner is rt)

    deadline = time.perf_counter() + CLOSE_S
    while True:
        end()
        if all(s.done() for s in streams.values()):
            break
        if time.perf_counter() > deadline:
            raise RuntimeError("sessions still running after the window")
        time.sleep(0.01)
    try:
        rt.close(timeout=0.5)
    except TimeoutError:
        pass                # the sessions ended above count as pending
    end()


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, control: bool = False) -> dict:
    from repro_torch import obs
    from repro_torch.core.lss import LSSConfig
    from repro_torch.serve.engine import LMDecoder
    from repro_torch.serve.runtime import AsyncRuntime

    cfg, mix = cell.config, cell.mix
    lss, head = cfg["lss"], mix["head"]
    obs.set_enabled(trace)
    obs.reset()
    params = weights.lm_weights(cfg, seed, device)
    theta = weights.hyperplanes(cfg["hidden_size"] + 1, lss["k_bits"],
                                lss["n_tables"], seed, device)
    plan = gen.session_plan(mix, cfg["vocab_size"], seed)
    p_lo, p_hi = mix["prompt_tokens"]
    dec = LMDecoder(params, _model_config(cfg),
                    LSSConfig(k_bits=lss["k_bits"], n_tables=lss["n_tables"],
                              capacity=lss["capacity"],
                              slab_dtype=lss["slab_dtype"]),
                    max_streams=mix["slots"],
                    max_len=p_hi + mix["output_tokens"][1],
                    kv_layout="paged", kv_page_tokens=mix["page_tokens"])
    dec.engine.swap_from_theta(theta)
    sched = dec.scheduler(head=head)
    rt = AsyncRuntime(dec.engine, head=head, scheduler=sched,
                      max_queue=4 * mix["clients"])
    wrng = gen.rng_for(seed, 4)
    warm = [rt.submit_decode(
        wrng.integers(0, cfg["vocab_size"], min(w, p_hi)).astype(np.int32),
        max_new_tokens=2) for w in gen.prefill_buckets(p_lo, p_hi)]
    for s in warm:
        s.result(timeout=RAMP_S)
    prof = Profiled(trace, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    ctx = LMContext(cfg, mix, params, theta, device)
    lock = threading.Lock()
    nxt = [0]
    streams: dict = {}
    go, stop = threading.Event(), threading.Event()
    exhausted = threading.Event()

    def client() -> None:
        go.wait()
        while True:
            with lock:                         # no session starts after stop
                if stop.is_set():
                    return
                i = nxt[0]
                nxt[0] += 1
                if i >= len(plan):
                    exhausted.set()
                    return
                stream = rt.submit_decode(plan[i][0],
                                          max_new_tokens=plan[i][1])
                streams[i] = stream
            stream.exception()                 # until it ends

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(mix["clients"])]
    for t in threads:
        t.start()
    go.set()
    first = range(mix["clients"])
    deadline = time.perf_counter() + RAMP_S
    while not all(i in streams and len(streams[i]) > 0 for i in first):
        if time.perf_counter() > deadline:
            raise RuntimeError("the first wave did not start streaming "
                               f"within {RAMP_S} s")
        time.sleep(0.005)
    with prof:
        t0 = prof.t0
        time.sleep(max(0.0, t0 + min(mix["trace_seconds"], seconds)
                       - time.perf_counter()))
        prof.stop()
        time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
    t1 = t0 + seconds
    with lock:
        stop.set()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    _end_sessions(rt, sched, streams)
    for t in threads:
        t.join(CLOSE_S)
    hung = sum(t.is_alive() for t in threads)
    ctx.window, ctx.prof = (t0, t1), prof
    prof.reduce()
    ctx.spans = _spans() if trace else []
    ctx.sessions = [Session(plan[i][0], s)
                    for i, s in sorted(streams.items())]
    del rt, sched, dec, warm
    free_program()

    e2e = decode_window([s.record for s in ctx.sessions], t0, t1)
    in_window = [s for s in ctx.sessions if s.record.t_submit <= t1 and (
        not len(s.tokens) or stream_token_times(s.record)[-1] >= t0)]
    bad = [s for s in ctx.sessions
           if s.reason == "error" and not s.closed_by_harness]
    checks, control_checks, compared = _judge(ctx, seed, control)
    return {"setup_s": setup_s,
            "e2e": {k: e2e[k] for k in ("tokens_per_s", "itl_p95_ms",
                                        "ttft_p95_ms")},
            "window_counts": {k: e2e[k] for k in ("tokens", "gaps",
                                                  "first_tokens")},
            "attempted": len(in_window), "failed": len(bad) + hung,
            "failures": [repr(s.error) for s in bad[:3]]
            + (["the session pool ran out"] if exhausted.is_set() else []),
            "peak_bytes": peak, "checks": checks,
            "control_checks": control_checks, "ctx": ctx,
            "compared": compared}


def _judge(ctx: LMContext, seed: int, control: bool):
    """A sample of the finished sessions, the longest among them, each
    session's every served token held against the reference run over its
    prompt and served tokens."""
    done = [s for s in ctx.sessions if s.reason == "max_tokens"]
    if not done:
        return {"rows": 0}, None, 0
    n = min(ctx.mix["check_sessions"], len(done))
    longest = max(done, key=lambda s: len(s.prompt) + len(s.tokens))
    rest = [s for s in done if s is not longest]
    pick = gen.rng_for(seed, 5).permutation(len(rest))[:n - 1]
    sample = [longest] + [rest[j] for j in sorted(pick)]
    index = ctx.index()
    w = ctx.params["embed"]
    parts, ctrl, compared = [], [], 0
    with torch.no_grad():
        for s in sample:
            seq = torch.from_numpy(np.concatenate([s.prompt, s.tokens[:-1]]))
            rows = slice(len(s.prompt) - 1, len(seq))
            h = qwen2.hidden_states(ctx.params, seq, ctx.cfg)[rows]
            ids = torch.from_numpy(s.tokens.astype(np.int64))[:, None]
            parts.append(judge.judge_lss(h.double(), index, w, None, ids))
            compared += len(s.tokens)
            if control:
                hc = qwen2.hidden_states(ctx.params, seq, ctx.cfg,
                                         precision="fp8")[rows]
                _, c_ids = heads.lss_topk(hc, index, w, None, 1)
                ctrl.append(judge.judge_lss(h.double(), index, w, None,
                                            c_ids))
    return judge.merge(parts), (judge.merge(ctrl) if control else None), \
        compared
