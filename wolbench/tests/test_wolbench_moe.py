"""The sparse-expert cell (``qwen2-moe-a2.7b-lss-reason``) on the CPU: its
plain reference against Hugging Face's equations written out here, its
cost model by hand, each new reader on a synthetic window, a tiny run
of the cell (sound, broken and the control), and the import guard for
its driver, readers and reference."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wolbench import control
from wolbench import run as bench_run
from wolbench.cost import moe, peaks
from wolbench.harness import guard, spec
from wolbench.harness.spans import Rec
from wolbench.harness.window import StreamRecord
from wolbench.reference import qwen2, qwen2_moe
from wolbench.tests.test_wolbench_imports import _modules
from wolbench.tests.tiny_moe import CELL, TinyMoECell

CFG = json.loads((spec.BENCH_DIR / "configs" / "qwen2-moe-a2.7b.json")
                 .read_text())


# ------------------------------------------------------------ reference --

def _tiny_cfg(**kw):
    cfg = {"hidden_size": 32, "num_attention_heads": 4,
           "num_key_value_heads": 2, "num_hidden_layers": 2,
           "rms_norm_eps": 1e-6, "rope_theta": 1e4, "num_experts": 5,
           "num_experts_per_tok": 2, "norm_topk_prob": False}
    cfg.update(kw)
    return cfg


def _tiny_params(cfg, seed=0, ep=8, f=12, fs=20, vocab=64):
    g = torch.Generator().manual_seed(seed)
    n, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    hd = d // cfg["num_attention_heads"]
    nq, nkv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd

    def r(*shape, s=None):
        return torch.randn(shape, generator=g) * (
            s if s is not None else shape[-2] ** -0.5)

    lay = {"ln1": 1 + r(n, d, s=0.1), "ln2": 1 + r(n, d, s=0.1),
           "wq": r(n, d, nq), "wk": r(n, d, nkv), "wv": r(n, d, nkv),
           "wo": r(n, nq, d), "bq": r(n, nq, s=0.1), "bk": r(n, nkv, s=0.1),
           "bv": r(n, nkv, s=0.1),
           "moe": {"router": r(n, d, ep), "w_gate": r(n, ep, d, f),
                   "w_up": r(n, ep, d, f), "w_down": r(n, ep, f, d)},
           "sh_gate": r(n, d, fs), "sh_up": r(n, d, fs),
           "sh_down": r(n, fs, d), "sh_gate_w": r(n, d, 1)}
    return {"embed": r(vocab, d, s=1.0), "layers": lay,
            "final_norm": 1 + r(d, s=0.1), "lm_head": r(vocab, d)}


def _hf_block(h, lay, i, cfg):
    """Hugging Face's ``Qwen2MoeSparseMoeBlock.forward``, token by token:
    softmax over the router's logits, top-k, weights renormalised only
    with ``norm_topk_prob``, each chosen expert's SwiGLU weighted, plus
    ``sigmoid(shared_expert_gate(h)) * shared_expert(h)``."""
    moe_p = lay["moe"]
    n_e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    out = torch.zeros_like(h, dtype=torch.float64)
    for t in range(h.shape[0]):
        x = h[t].double()
        logits = x @ moe_p["router"][i][:, :n_e].double()
        w, sel = torch.topk(F.softmax(logits, dim=-1), k)
        if cfg["norm_topk_prob"]:
            w = w / w.sum()
        for wt, e in zip(w, sel):
            g = x @ moe_p["w_gate"][i, e].double()
            u = x @ moe_p["w_up"][i, e].double()
            out[t] += wt * ((F.silu(g) * u) @ moe_p["w_down"][i, e].double())
        sh = (F.silu(x @ lay["sh_gate"][i].double())
              * (x @ lay["sh_up"][i].double())) @ lay["sh_down"][i].double()
        out[t] += torch.sigmoid(x @ lay["sh_gate_w"][i].double())[0] * sh
    return out


@pytest.mark.parametrize("norm", [False, True])
def test_the_sparse_block_is_hugging_faces(norm):
    cfg = _tiny_cfg(norm_topk_prob=norm)
    params = _tiny_params(cfg)
    h = torch.randn(9, 32, generator=torch.Generator().manual_seed(2))
    for i in range(2):
        got = qwen2_moe.sparse_block(h, params["layers"], i, cfg)
        want = _hf_block(h, params["layers"], i, cfg)
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    other = qwen2_moe.sparse_block(h, params["layers"], 0,
                                   _tiny_cfg(norm_topk_prob=not norm))
    assert float((other.double() - _hf_block(
        h, params["layers"], 0, cfg)).abs().max()) > 1e-2


def test_one_expert_and_no_shared_output_is_the_dense_qwen2():
    """With one expert picked with weight 1 and the shared expert's output
    zeroed, the decoder is ``reference/qwen2.py``'s dense one whose SwiGLU
    is that expert: the attention half is the tested one."""
    cfg = _tiny_cfg(num_experts=1, num_experts_per_tok=1,
                    norm_topk_prob=False)
    params = _tiny_params(cfg)
    lay = params["layers"]
    lay["sh_down"] = torch.zeros_like(lay["sh_down"])
    dense = {"embed": params["embed"], "final_norm": params["final_norm"],
             "layers": {k: v for k, v in lay.items()
                        if not k.startswith("sh") and k != "moe"}}
    dense["layers"].update(w_gate=lay["moe"]["w_gate"][:, 0],
                           w_up=lay["moe"]["w_up"][:, 0],
                           w_down=lay["moe"]["w_down"][:, 0])
    toks = torch.tensor([3, 17, 5, 60, 2, 9, 41])
    got = qwen2_moe.hidden_states(params, toks, cfg, q_block=3)
    want = qwen2.hidden_states(dense, toks, cfg, q_block=3)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_the_fp8_control_departs():
    cfg = _tiny_cfg()
    params = _tiny_params(cfg)
    toks = torch.arange(11) * 5 % 64
    ref = qwen2_moe.hidden_states(params, toks, cfg)
    fp8 = qwen2_moe.hidden_states(params, toks, cfg, precision="fp8")
    rel = float((fp8 - ref).abs().max() / ref.abs().max())
    assert 1e-3 < rel < 0.5


# ------------------------------------------------------------ the cost --

def test_active_parameters_and_step_bytes_by_hand():
    attn = 4 * 2048 * 2048
    router = 2048 * 60
    shared = 3 * 2048 * 5632 + 2048
    expert = 3 * 2048 * 1408
    assert moe.active_linear_params(CFG) == 24 * (attn + router + shared
                                                  + 4 * expert)
    # with the embedding and lm_head, Qwen's "A2.7B": 2.69 billion
    assert (moe.active_linear_params(CFG) + 2 * 151936 * 2048) / 1e9 == \
        pytest.approx(2.69, abs=0.01)
    assert moe.expert_bytes(CFG) == expert * 2
    assert moe.step_weight_bytes(CFG) == 24 * ((attn + shared) * 2
                                               + router * 4)
    assert moe.kv_bytes_per_position(CFG) == 196_608
    assert moe.scored_bytes(CFG, 10) == 10 * 2049 * 4
    lss = (2 * 2049 * 10, 2 * 2049)
    assert moe.decode_token_flops(CFG, 100, 10, 1, 300) == \
        2 * moe.active_linear_params(CFG) + 4 * 24 * 16 * 128 * 100 \
        + lss[0] + lss[1] * 300
    assert moe.prefill_flops(CFG, 8, 10, 1, 300) == \
        2 * moe.active_linear_params(CFG) * 8 \
        + 4 * 24 * 16 * 128 * 8 * 9 / 2 + lss[0] + lss[1] * 300


# ------------------------------------------------------------ readers --

def _session(plen, t_submit, ttft, gaps):
    return SimpleNamespace(prompt=np.zeros(plen, np.int32),
                           tokens=np.zeros(len(gaps) + (ttft is not None),
                                           np.int64),
                           record=StreamRecord(t_submit, ttft,
                                               np.asarray(gaps, float)))


def _tick(t0, t1, **args):
    return Rec("tick", t0, t1, args, None)


def _ctx(busy_s=1.0, ticks=None):
    window = {"window_s": 10.0, "busy_s": busy_s,
              "device_ns": {"x": int(busy_s * 1e9)},
              "device_count": {"x": 1}}
    sessions = [
        # tokens at 9.5 + j: j = 1..10 land in [10, 20]; j = 0 and 11 not
        _session(100, 9.0, 0.5, [1.0] * 11),
        # its first token lands inside (a prefill of 50) and j = 1..3
        _session(50, 12.0, 0.25, [2.0] * 3),
    ]
    if ticks is None:
        ticks = [_tick(11.0, 11.5, experts_hit=300, moe_layers=24),
                 _tick(12.0, 12.5, experts_hit=600, moe_layers=24),
                 _tick(19.8, 20.5, experts_hit=900, moe_layers=24),  # ends out
                 _tick(12.5, 13.0, active=3)]              # no routing
    ctx = SimpleNamespace(kind="lm", cfg=CFG, sessions=sessions,
                          window=(10.0, 20.0),
                          prof=SimpleNamespace(t0=10.0, t1=20.0,
                                               window=window),
                          scored=lambda toks: np.full(len(toks), 300))
    ctx._program_spans = ticks
    return ctx


def test_step_roofline_by_hand():
    positions = sum(100 + j for j in range(1, 11)) + (51 + 52 + 53)
    total = (2 * moe.step_weight_bytes(CFG) + 900 * moe.expert_bytes(CFG)
             + positions * 196_608 + 13 * 300 * 2049 * 4)
    want = 100.0 * total / peaks.HBM_BYTES_PER_S / 1.0
    assert spec.reader("step_roofline.moe")(_ctx()) == \
        pytest.approx(want, rel=1e-12)


def test_experts_hit_pct_by_hand():
    got = spec.reader("experts_hit_pct.moe")(_ctx())
    want = 100.0 * np.mean([300 / (24 * 60), 600 / (24 * 60),
                            900 / (24 * 60)])
    assert got == pytest.approx(want, rel=1e-12)


def test_mfu_moe_by_hand():
    decode = sum(moe.decode_token_flops(CFG, 100 + j, 10, 1, 300)
                 for j in range(1, 11))
    decode += sum(moe.decode_token_flops(CFG, 50 + j, 10, 1, 300)
                  for j in range(1, 4))
    total = decode + moe.prefill_flops(CFG, 50, 10, 1, 300)
    want = 100.0 * total / (10.0 * peaks.BF16_FLOPS)
    assert spec.reader("mfu.moe")(_ctx()) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric", ["step_roofline.moe",
                                    "experts_hit_pct.moe", "mfu.moe"])
@pytest.mark.parametrize("case", ["no_routing", "no_profile", "idle",
                                  "dense"])
def test_none_where_nothing_was_read(metric, case):
    ctx = _ctx()
    if case == "no_routing":          # a program without the counts
        ctx._program_spans = [_tick(11.0, 11.5, active=3)]
        if metric == "mfu.moe":       # reads no span: tokens only
            ctx.sessions = []
    elif case == "no_profile":
        ctx.prof = None
        if metric == "experts_hit_pct.moe":    # spans of an untraced run
            ctx._program_spans = []
    elif case == "idle":                       # a run on the CPU
        ctx.prof.window["busy_s"] = 0.0
        if metric == "experts_hit_pct.moe":
            ctx._program_spans = []
    else:
        ctx.cfg = {k: v for k, v in CFG.items() if k != "num_experts"}
    assert spec.reader(metric)(ctx) is None


# ------------------------------------------------------------ the cell --

def _correct(cell, res) -> bool:
    return bench_run.verdict(res, bench_run.checks_of(cell, res))


def test_the_cell_is_uncut_and_resolves():
    cell = spec.find_cell(CELL)
    assert cell.chips == 1 and cell.config["reduced"] == []
    assert cell.config["kind"] == "moe_lm"
    assert (cell.mix["slots"], cell.mix["clients"]) == (32, 32)
    names = {m["name"] for m in cell.per_layer}
    assert names == {"tick_ms.moe", "device_idle_pct.moe",
                     "decode_attn_roofline.moe", "mfu.moe",
                     "step_roofline.moe", "experts_hit_pct.moe",
                     "dispatch_ms.moe", "collect_ms.moe",
                     "slot_occupancy.moe"}
    assert {m["name"] for m in cell.end_to_end} == {
        "setup_s", "tokens_per_s", "itl_p95_ms"}


def test_a_sound_run_is_correct_and_its_traced_readers_read():
    cell = TinyMoECell()
    res = cell.run(trace=True)
    assert res["compared"] > 0 and res["failed"] == 0
    assert _correct(cell, res), res["checks"]
    ctx = res["ctx"]
    assert ctx.kind == "lm"
    assert spec.reader("tick_ms.moe")(ctx) > 0
    assert 0 < spec.reader("experts_hit_pct.moe")(ctx) <= 100
    assert spec.reader("dispatch_ms.moe")(ctx) > 0
    assert spec.reader("collect_ms.moe")(ctx) > 0
    assert 0 < spec.reader("slot_occupancy.moe")(ctx) <= 100
    # the CPU has no device records: the device readers find nothing
    for name in ("device_idle_pct.moe", "decode_attn_roofline.moe",
                 "mfu.moe", "step_roofline.moe"):
        assert spec.reader(name)(ctx) is None


def _alter_head(monkeypatch):
    """The LSS head's first answer moved to the next neuron."""
    from repro_torch.serve import heads

    lss = heads.lss_forward

    def lss_forward(*a, **k):
        out = lss(*a, **k)
        ids = out.top_ids.clone()
        ids[:, 0] = ids[:, 0] + 1
        return out._replace(top_ids=ids)

    monkeypatch.setattr(heads, "lss_forward", lss_forward)


def _renormalised(monkeypatch):
    """The routing weights renormalised, as the JAX package's are."""
    from repro_torch.models import transformer as T

    monkeypatch.setattr(T.TransformerConfig, "moe_cfg", property(
        lambda self: T.MoEConfig(self.n_experts, self.moe_top_k,
                                 self.d_model, self.moe_d_ff,
                                 self.n_experts_padded, self.capacity_factor,
                                 n_groups=self.moe_groups)))


def _no_shared_expert(monkeypatch):
    """The shared expert left out of every layer."""
    from repro_torch.models import transformer as T

    block = T._ffn_block

    def ffn_block(x, lp, cfg, *a, **k):
        return block(x, lp, cfg._replace(shared_expert_ff=0), *a, **k)

    monkeypatch.setattr(T, "_ffn_block", ffn_block)


@pytest.mark.parametrize("fault", [_alter_head, _renormalised,
                                   _no_shared_expert])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    cell = TinyMoECell()
    res = cell.run()
    assert not _correct(cell, res), res["checks"]


def test_the_control_fails_the_limits():
    cell = TinyMoECell()
    res = cell.run(seconds=2.0, control=True)
    assert _correct(cell, res), res["checks"]
    ctrl_ok, ctrl_checks = control.control_verdict(cell, res)
    assert ctrl_checks and not ctrl_ok, ctrl_checks


# ------------------------------------------------------- import guard --

def test_the_cell_loads_no_jax():
    """The driver, its readers and the reference, through a tiny run of
    the cell and its traced readers."""
    mods = _modules(
        "import wolbench.run\n"
        "from wolbench.tests.tiny_moe import TinyMoECell\n"
        "from wolbench.harness import spec\n"
        "cell = TinyMoECell()\n"
        "res = cell.run(seconds=0.5, trace=True, control=True)\n"
        "for m in cell.per_layer:\n"
        "    spec.reader(m['name'])(res['ctx'])\n")
    assert "repro_torch" in {m.split(".")[0] for m in mods}
    assert "wolbench.harness.moe_lm_cell" in mods
    assert guard.forbidden_modules(mods) == []


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(
        "import torch\n"
        "from wolbench.reference import qwen2_moe\n"
        "cfg = dict(hidden_size=16, num_attention_heads=2,\n"
        "           num_key_value_heads=2, num_hidden_layers=1,\n"
        "           rms_norm_eps=1e-6, rope_theta=1e4, num_experts=3,\n"
        "           num_experts_per_tok=2, norm_topk_prob=False)\n"
        "r = lambda *s: torch.randn(s)\n"
        "lay = dict(ln1=r(1, 16), ln2=r(1, 16), wq=r(1, 16, 16),\n"
        "           wk=r(1, 16, 16), wv=r(1, 16, 16), wo=r(1, 16, 16),\n"
        "           bq=r(1, 16), bk=r(1, 16), bv=r(1, 16),\n"
        "           moe=dict(router=r(1, 16, 4), w_gate=r(1, 4, 16, 8),\n"
        "                    w_up=r(1, 4, 16, 8), w_down=r(1, 4, 8, 16)),\n"
        "           sh_gate=r(1, 16, 8), sh_up=r(1, 16, 8),\n"
        "           sh_down=r(1, 8, 16), sh_gate_w=r(1, 16, 1))\n"
        "p = dict(embed=r(20, 16), layers=lay, final_norm=r(16))\n"
        "qwen2_moe.hidden_states(p, torch.arange(5), cfg)\n"
        "qwen2_moe.hidden_states(p, torch.arange(5), cfg, precision='fp8')\n")
    tops = {m.split(".")[0] for m in mods}
    assert "repro_torch" not in tops and "wolbench" in tops
    assert not any(m.startswith(("wolbench.harness", "wolbench.metrics"))
                   for m in mods)
    assert guard.forbidden_modules(mods) == []
