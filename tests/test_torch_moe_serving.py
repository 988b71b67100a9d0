"""The port's MoE decoder as Qwen1.5-MoE-A2.7B serves it, on the CPU at a
tiny size with seeded random weights: dropless routing
(``capacity_factor`` None), the softmax weights not renormalised
(``norm_topk_prob`` False), an untied ``lm_head`` and the gated shared
expert, served through ``LMDecoder``'s scheduler with paged KV, prefill
then decode, held on logits against the benchmark's plain reference
(``wolbench/reference/qwen2_moe.py``, float32, one sequence at a time, a
loop over the experts).  Besides: rows of a 32-row decode step that do
not depend on their neighbours, a prefill over the old capacity that
drops nothing, ``norm_topk_prob=True`` as the routing was, and the
routing counts on the ``tick`` and ``prefill`` spans of MoE models only.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core.lss import LSSConfig  # noqa: E402
from repro_torch.core.topk import topk_lowest_index  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import LMDecoder  # noqa: E402
from repro_torch.serve.decode import scheduler as S  # noqa: E402
from repro_torch.testing.parity import assert_close  # noqa: E402
from wolbench.reference import qwen2_moe  # noqa: E402

# float32 on both sides; sums in other orders (blockwise against whole
# attention, batched against per-expert products, the pool's gathered
# view) differ by ~1e-6 of a logit of ~1, and a wrong routing weight
# moves one by more than 1e-2 (checked below), so 1e-4 tells them apart
LOGIT_TOL = 1e-4
# one row alone against the same row among 31 others: products of other
# shapes, so not bit for bit (the existing eight-slot test's tolerance)
ROW_TOL = 1e-5

CFG = T.TransformerConfig(
    name="moe-serve", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
    head_dim=16, d_ff=48, vocab=512, qkv_bias=True, rope_base=1e6,
    dtype=torch.float32, kv_chunk=32, moe_style="replace", n_experts=6,
    n_experts_padded=8, moe_top_k=2, moe_d_ff=24, shared_expert_ff=40,
    capacity_factor=None, norm_topk_prob=False, tie_embeddings=False)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(cfg=CFG, seed=0):
    """The port's initial parameters with every bias and norm scale drawn
    too (the port starts them at 0 and 1)."""
    g = torch.Generator().manual_seed(seed)
    p = T.init_params(g, cfg, device="cpu")
    lay = p["layers"]
    for name in ("bq", "bk", "bv"):
        lay[name] = 0.1 * torch.randn(lay[name].shape, generator=g)
    for name in ("ln1", "ln2"):
        lay[name] = 1 + 0.1 * torch.randn(lay[name].shape, generator=g)
    p["final_norm"] = 1 + 0.1 * torch.randn(p["final_norm"].shape,
                                            generator=g)
    return p


def _ref_cfg(cfg=CFG, norm_topk_prob=None):
    """The reference's keys (Hugging Face's names) for a port config."""
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "rms_norm_eps": 1e-6,
            "rope_theta": cfg.rope_base, "num_hidden_layers": cfg.n_layers,
            "num_experts": cfg.n_experts,
            "num_experts_per_tok": cfg.moe_top_k,
            "norm_topk_prob": (cfg.norm_topk_prob if norm_topk_prob is None
                               else norm_topk_prob)}


def _serve(params, prompts, new_tokens, monkeypatch, max_streams=4):
    """Serve ``prompts`` through the paged scheduler's full head; returns
    each session's tokens and the final-norm hidden row behind each token
    (the prefill's last real row, then the fused steps' rows)."""
    dec = LMDecoder(params, CFG, LSSConfig(k_bits=4, n_tables=1),
                    max_streams=max_streams, max_len=48, kv_layout="paged",
                    kv_page_tokens=8)
    sched = dec.scheduler(head="full")
    first = {}
    prefill = S._prefill

    def rec_prefill(p, prompt, cfg, max_len, *counts):
        hidden, cache = prefill(p, prompt, cfg, max_len, *counts)
        first[prompt.numpy().tobytes()] = hidden[0].clone()
        return hidden, cache

    monkeypatch.setattr(S, "_prefill", rec_prefill)
    rows: dict = {}
    collect = sched._collect

    def rec_collect(item):
        for slot, sess in item.snapshot:
            if not sess.finished:
                rows.setdefault(sess.sid, []).append(item.out[0][slot])
        return collect(item)

    sched._collect = rec_collect
    sessions = [sched.make_session(p, new_tokens) for p in prompts]
    for s in sessions:
        sched.add_session(s)
    sched.run(timeout=120)
    out = []
    for s, p in zip(sessions, prompts):
        bucket = S._prefill_bucket(len(p))
        padded = np.zeros(bucket, np.int32)
        padded[:len(p)] = p
        h0 = first[padded.reshape(1, -1).tobytes()][len(p) - 1]
        out.append((np.asarray(s.stream.result()),
                    torch.stack([h0] + rows[s.sid])))
    return out


def test_paged_decode_matches_the_reference_on_logits(monkeypatch):
    params = _params()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, CFG.vocab, n).astype(np.int32)
               for n in (5, 9, 13, 20)]
    head = params["lm_head"]
    for prompt, (tokens, hidden) in zip(
            prompts, _serve(params, prompts, 12, monkeypatch)):
        assert len(tokens) == 12
        seq = torch.from_numpy(np.concatenate([prompt, tokens[:-1]]))
        rows = slice(len(prompt) - 1, len(seq))
        ref_h = qwen2_moe.hidden_states(params, seq, _ref_cfg())[rows]
        got = hidden @ head.T
        want = ref_h @ head.T
        assert_close(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                     what="logits")
        # the served (greedy) tokens are the reference's best
        best = want.max(-1).values
        mine = want.gather(1, torch.from_numpy(tokens)[:, None].long())[:, 0]
        assert torch.all(mine >= best - LOGIT_TOL)
        # the published weights are not renormalised: that reading is far
        renorm = qwen2_moe.hidden_states(params, seq, _ref_cfg(
            norm_topk_prob=True))[rows] @ head.T
        assert float((renorm - want).abs().max()) > 100 * LOGIT_TOL


def _decode_inputs(b, seed=9, cfg=CFG):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, b, 16, cfg.n_kv_heads, cfg.head_dim)
    k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, b).astype(np.int64))
    lengths = torch.from_numpy(rng.integers(1, 16, b).astype(np.int64))
    return tok, k, v, lengths


@pytest.mark.parametrize("cf", [None, 1.25])
def test_rows_of_a_32_row_step_do_not_depend_on_their_neighbours(cf):
    """Dropless, each row of a 32-row decode step equals the row decoded
    alone; with the capacity (C = max(8, 1.25 * 32 * 2 / 8) = 10 against
    a mean load of 64 / 6) some rows lose an expert to their neighbours."""
    cfg = CFG._replace(capacity_factor=cf)
    params = _params(cfg)
    tok, k, v, lengths = _decode_inputs(32, cfg=cfg)
    counts = T.new_expert_counts(cfg, "cpu")
    h32, _, _ = T.decode_step_pooled(params, tok, k.clone(), v.clone(),
                                     lengths, cfg, expert_counts=counts)
    # every row routed to top-k distinct experts, the pads never
    assert counts.sum(1).tolist() == [32 * cfg.moe_top_k] * cfg.n_layers
    assert int(counts[:, cfg.n_experts:].sum()) == 0
    assert int(counts.max()) > 10                 # over the capacity
    alone = []
    for r in range(32):
        h1, _, _ = T.decode_step_pooled(
            params, tok[r:r + 1], k[:, r:r + 1].clone(),
            v[:, r:r + 1].clone(), lengths[r:r + 1], cfg)
        alone.append(h1[0])
    alone = torch.stack(alone)
    if cf is None:
        assert_close(h32, alone, rtol=ROW_TOL, atol=ROW_TOL, what="rows")
    else:
        assert float((h32 - alone).abs().max()) > 100 * ROW_TOL


def test_a_prefill_over_the_old_capacity_drops_nothing():
    """64 tokens, most to expert 0 (C would be max(8, 1.25 * 64 * 2 / 8)
    = 20): dropless, grouped (prefill) and static (decode) both give the
    no-drop oracle's output; the capacity path does not."""
    cfg = CFG.moe_cfg
    g = torch.Generator().manual_seed(4)
    params = M.init_moe_params(g, cfg, device="cpu")
    params["router"][:, 0] += 0.5
    x = torch.randn(64, cfg.d_model, generator=g) + 1.0   # logit 0 up ~16
    want = M.moe_ffn_dense_oracle(x, params, cfg)
    routed = torch.zeros(cfg.n_experts_padded, dtype=torch.int32)
    grouped, _ = M.moe_ffn(x, params, cfg, static=False, counts=routed)
    static, _ = M.moe_ffn(x, params, cfg, static=True)
    top_e = M.router_topk(x, params["router"], cfg)[0]
    assert routed.tolist() == torch.bincount(
        top_e.reshape(-1), minlength=cfg.n_experts_padded).tolist()
    assert int(routed[0]) > 20
    assert_close(grouped, want, rtol=ROW_TOL, atol=ROW_TOL, what="grouped")
    assert_close(static, want, rtol=ROW_TOL, atol=ROW_TOL, what="static")
    capped, _ = M.moe_ffn(x, params, cfg._replace(capacity_factor=1.25))
    assert float((capped - want).abs().max()) > 100 * ROW_TOL


def test_norm_topk_prob_true_is_the_routing_as_it_was():
    """True (the default) gives the renormalised weights of the JAX
    package's routing, computed as before, bit for bit; False gives the
    softmax's own probabilities."""
    g = torch.Generator().manual_seed(5)
    cfg = M.MoEConfig(n_experts=60, top_k=4, d_model=16, d_ff=8,
                      n_experts_padded=64)
    assert cfg.norm_topk_prob
    params = M.init_moe_params(g, cfg, device="cpu")
    x = torch.randn(40, 16, generator=g)
    logits = x @ params["router"]
    pad = torch.arange(64) >= 60
    probs = torch.softmax(torch.where(pad[None], -1e30, logits), dim=-1)
    top_e = topk_lowest_index(probs, 4)[1]
    p = probs.gather(-1, top_e)
    before = p / p.sum(-1, keepdim=True).clamp(min=1e-9)
    got_e, got_p, _ = M.router_topk(x, params["router"], cfg)
    assert torch.equal(got_e, top_e) and torch.equal(got_p, before)
    raw_e, raw_p, _ = M.router_topk(x, params["router"],
                                    cfg._replace(norm_topk_prob=False))
    assert torch.equal(raw_e, top_e) and torch.equal(raw_p, p)
    out, _ = M.moe_ffn(x, params, cfg)
    same, _ = M.moe_ffn(x, params, cfg._replace(norm_topk_prob=True))
    assert torch.equal(out, same)


@pytest.fixture
def _obs_on():
    was = obs.enabled()
    obs.set_enabled(True)
    obs.reset_tracer()
    yield
    obs.reset_tracer()
    obs.set_enabled(was)


@pytest.mark.parametrize("moe", [True, False])
def test_tick_and_prefill_spans_carry_the_routing_of_moe_models(moe,
                                                                _obs_on):
    cfg = CFG if moe else CFG._replace(moe_style="none", n_experts=0,
                                       n_experts_padded=0, moe_top_k=0,
                                       shared_expert_ff=0)
    params = _params(cfg)
    dec = LMDecoder(params, cfg, LSSConfig(k_bits=4, n_tables=1),
                    max_streams=3, max_len=32, kv_layout="paged",
                    kv_page_tokens=8)
    rng = np.random.default_rng(1)
    dec.generate(rng.integers(0, cfg.vocab, (3, 7)), 5, head="full")
    spans = [e for e in obs.trace_export(include_open=False)["traceEvents"]
             if e["ph"] == "X" and e["name"] in ("tick", "prefill")]
    keys = {"experts_hit", "expert_max", "moe_layers"}
    ticks = [e["args"] for e in spans
             if e["name"] == "tick" and e["args"].get("collected")]
    prefills = [e["args"] for e in spans if e["name"] == "prefill"]
    assert len(prefills) == 3 and ticks
    if not moe:
        assert not any(keys & a.keys() for a in ticks + prefills)
        assert T.new_expert_counts(cfg, "cpu") is None
        return
    for a in ticks:
        # 3 rows of top-2 in each of 2 layers of 6 experts
        assert a["moe_layers"] == 2
        assert 2 <= a["experts_hit"] <= 2 * 6
        assert 1 <= a["expert_max"] <= 3
    for a in prefills:                            # 8 padded positions
        assert a["moe_layers"] == 2
        assert 2 <= a["experts_hit"] <= 2 * 6
        assert 8 * 2 / 6 <= a["expert_max"] <= 8
