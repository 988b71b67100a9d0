"""Driver of the ``moe_lm`` cells: a sparse-expert decoder (Qwen2-MoE:
routed experts and a gated shared expert in every layer, an untied
``lm_head``) served by the port's ``LMDecoder`` (paged KV, dropless
routing, the LSS head over ``lm_head``) behind its ``AsyncRuntime``,
under a ``sessions`` mix.

It runs as the ``lm`` driver (``lm_cell``) runs, whose sessions, window
and end it shares: set-up makes the weights, theta and the session pool
from the seed, builds the decoder, flips its engine to the index of
theta and serves one short session at each prefill width the mix's
prompts use (the fused decode step, the first-token step and every
prefill shape); ``clients`` threads then keep one session each running;
the window opens once every first-wave session has its first token.
After it, the sessions still running are ended, the program freed, and
a sample of the finished sessions, the longest among them, is held
against the plain reference (``reference/qwen2_moe.py``) through the LSS
judge, on the reference's logits of what was served (and, for a control
run, the reference's fp8 picks too).  What differs: the weights (the
MoE leaves in the port's layout, ``lm_head``), the model's config
(dropless, the published routing weights, untied), and the index, built
over ``lm_head``.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from wolbench.harness import weights
from wolbench.harness.lm_cell import (CLOSE_S, RAMP_S, LMContext, Session,
                                      _end_sessions, _spans)
from wolbench.harness.profiling import Profiled
from wolbench.harness.window import decode_window, stream_token_times
from wolbench.harness.xc_cell import free_program
from wolbench.reference import common, heads, judge, qwen2_moe
from wolbench.traffic import generator as gen

__all__ = ["run", "moe_weights", "MoEContext"]


class MoEContext(LMContext):
    """What the cell's metric readers read; ``kind`` stays ``lm`` (the
    decode readers' kind), the index is over the untied ``lm_head``."""

    def index(self) -> common.Index:
        if self._index is None:
            lss = self.cfg["lss"]
            self._index = common.build_index(
                self.params["lm_head"], None, self.theta, lss["k_bits"],
                lss["n_tables"], lss["capacity"])
        return self._index


def moe_weights(cfg: dict, seed: int, device: torch.device) -> dict:
    """A Qwen2-MoE decoder's parameters in the port's layout: ``embed``,
    ``lm_head``, ``final_norm`` and ``layers`` (each leaf stacked over the
    layers; the experts under ``moe``: ``router [d, Ep]`` float32,
    ``w_gate``/``w_up [Ep, d, f]``, ``w_down [Ep, f, d]``; the shared
    expert's ``sh_gate``/``sh_up [d, f_s]``, ``sh_down [f_s, d]`` and its
    gate ``sh_gate_w [d, 1]``); bf16 but the norm scales and the router.
    Every projection is N(0, 1) over its fan-in's square root."""
    g = weights.generator(device, seed, 0)
    init = cfg["init"]
    n, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    ep, f = cfg["n_experts_padded"], cfg["moe_intermediate_size"]
    fs = cfg["shared_expert_intermediate_size"]
    hd = cfg["head_dim"]
    nq, nkv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    bf, f32 = torch.bfloat16, torch.float32

    def proj(shape, dtype=bf):
        return weights._normal(g, shape, shape[-2] ** -0.5, dtype, device)

    def norm(shape):
        return weights._normal(g, shape, init["norm_std"], f32, device,
                               mean=1.0)

    def bias(shape):
        return weights._normal(g, shape, init["bias_std"], bf, device)

    layers = {
        "ln1": norm((n, d)), "ln2": norm((n, d)),
        "wq": proj((n, d, nq)), "wk": proj((n, d, nkv)),
        "wv": proj((n, d, nkv)), "wo": proj((n, nq, d)),
        "bq": bias((n, nq)), "bk": bias((n, nkv)), "bv": bias((n, nkv)),
        "moe": {"router": proj((n, d, ep), f32),
                "w_gate": proj((n, ep, d, f)), "w_up": proj((n, ep, d, f)),
                "w_down": proj((n, ep, f, d))},
        "sh_gate": proj((n, d, fs)), "sh_up": proj((n, d, fs)),
        "sh_down": proj((n, fs, d)), "sh_gate_w": proj((n, d, 1)),
    }
    return {"embed": weights._normal(g, (cfg["vocab_size"], d),
                                     init["embed_std"], bf, device),
            "layers": layers, "final_norm": norm((d,)),
            "lm_head": weights._normal(g, (cfg["vocab_size"], d), d ** -0.5,
                                       bf, device)}


def _model_config(cfg: dict):
    from repro_torch.models.transformer import TransformerConfig
    return TransformerConfig(
        name=cfg["name"], n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        qkv_bias=True, qk_norm=False, rope_base=float(cfg["rope_theta"]),
        tie_embeddings=cfg["tie_word_embeddings"], moe_style="replace",
        n_experts=cfg["num_experts"],
        n_experts_padded=cfg["n_experts_padded"],
        moe_top_k=cfg["num_experts_per_tok"],
        moe_d_ff=cfg["moe_intermediate_size"],
        shared_expert_ff=cfg["shared_expert_intermediate_size"],
        capacity_factor=None, norm_topk_prob=cfg["norm_topk_prob"],
        dtype=torch.bfloat16)


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
    model_cfg = _model_config(cfg)        # a program without it: at once
    params = moe_weights(cfg, seed, device)
    theta = weights.hyperplanes(cfg["hidden_size"] + 1, lss["k_bits"],
                                lss["n_tables"], seed, device)
    plan = gen.session_plan(mix, cfg["vocab_size"], seed)
    p_lo, p_hi = mix["prompt_tokens"]
    dec = LMDecoder(params, model_cfg,
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

    ctx = MoEContext(cfg, mix, params, theta, device)
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


def _judge(ctx: MoEContext, seed: int, control: bool):
    """A sample of the finished sessions, the longest among them, each
    session's every served token held against the reference run over its
    prompt and served tokens, as ``lm_cell`` judges them."""
    done = [s for s in ctx.sessions if s.reason == "max_tokens"]
    if not done:
        return {"rows": 0}, None, 0
    n = min(ctx.mix["check_sessions"], len(done))
    longest = max(done, key=lambda s: len(s.prompt) + len(s.tokens))
    rest = [s for s in done if s is not longest]
    pick = gen.rng_for(seed, 5).permutation(len(rest))[:n - 1]
    sample = [longest] + [rest[j] for j in sorted(pick)]
    index = ctx.index()
    w = ctx.params["lm_head"]
    parts, ctrl, compared = [], [], 0
    with torch.no_grad():
        for s in sample:
            seq = torch.from_numpy(np.concatenate([s.prompt, s.tokens[:-1]]))
            rows = slice(len(s.prompt) - 1, len(seq))
            h = qwen2_moe.hidden_states(ctx.params, seq, ctx.cfg)[rows]
            ids = torch.from_numpy(s.tokens.astype(np.int64))[:, None]
            parts.append(judge.judge_lss(h.double(), index, w, None, ids))
            compared += len(s.tokens)
            if control:
                hc = qwen2_moe.hidden_states(ctx.params, seq, ctx.cfg,
                                             precision="fp8")[rows]
                _, c_ids = heads.lss_topk(hc, index, w, None, 1)
                ctrl.append(judge.judge_lss(h.double(), index, w, None,
                                            c_ids))
    return judge.merge(parts), (judge.merge(ctrl) if control else None), \
        compared
