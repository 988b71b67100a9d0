"""The plain reference at tiny sizes on the CPU: the index, the two heads,
the judge, and the Qwen2 forward against an independent causal forward
and against the port's own (test-only) at float32."""

import math

import numpy as np
import pytest
import torch

from wolbench.reference import common, heads, judge, qwen2
from wolbench.reference import xc as ref_xc


def _xc(seed=0, m=300, d=12, k_bits=4, cap=40):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(m, d, generator=g)
    b = torch.randn(m, generator=g) * 0.1
    theta = torch.randn(d + 1, k_bits, generator=g)
    return w, b, theta, common.build_index(w, b, theta, k_bits, 1, cap)


def test_index_holds_each_neuron_once_in_its_bucket_in_id_order():
    w, b, theta, idx = _xc()
    proj = common.projections(common.augment(w, b), theta)
    bucket = common.pack(proj, 4)[:, 0]
    seen = idx.table[idx.table >= 0]
    assert seen.unique().numel() == seen.numel()
    for j in range(16):
        ids = idx.table[0, j][idx.table[0, j] >= 0]
        want = torch.nonzero(bucket == j).flatten()[:40]
        assert torch.equal(ids, want)
        assert torch.all(idx.bucket_of[ids, 0] == j)
    dropped = idx.bucket_of[:, 0] < 0
    assert torch.all(torch.bincount(bucket[dropped], minlength=16)[
        torch.unique(bucket[dropped])] > 0)
    assert torch.allclose(idx.margin, proj.abs())


def test_capacity_drops_the_highest_ids_of_a_full_bucket():
    w, b, theta, idx = _xc(cap=8)
    bucket = common.pack(common.projections(common.augment(w, b), theta),
                         4)[:, 0]
    for j in range(16):
        members = torch.nonzero(bucket == j).flatten()
        assert torch.all(idx.bucket_of[members[8:], 0] == -1)


def test_lss_topk_is_the_best_of_the_bucket():
    w, b, theta, idx = _xc()
    q = torch.randn(20, 12, generator=torch.Generator().manual_seed(3))
    lg, ids = heads.lss_topk(q, idx, w, None, 5)
    bucket = common.pack(common.projections(common.augment(q), theta),
                         4)[:, 0]
    for r in range(20):
        cand = idx.table[0, bucket[r]]
        cand = cand[cand >= 0]
        s = (w[cand].double() @ q[r].double())
        order = torch.argsort(-s, stable=True)[:5]
        assert torch.equal(ids[r][:len(order)], cand[order])
        assert torch.allclose(lg[r][:len(order)], s[order])


def test_full_topk_matches_a_sort():
    w, b, _, _ = _xc()
    q = torch.randn(7, 12, generator=torch.Generator().manual_seed(4))
    lg, ids = heads.full_topk(q, w, b, 5, rows=3)
    s = q.double() @ w.double().T + b.double()
    vals, want = torch.sort(s, dim=1, descending=True, stable=True)
    assert torch.equal(ids, want[:, :5])
    assert torch.allclose(lg, vals[:, :5])


def test_embed_bag_is_the_mean_of_valid_rows_then_relu():
    table = torch.randn(50, 4, generator=torch.Generator().manual_seed(5))
    ids = torch.tensor([[1, 2, -1], [3, 3, 7]])
    got = ref_xc.embed_bag(table, ids)
    want = torch.relu(torch.stack([table[[1, 2]].double().mean(0),
                                   table[[3, 3, 7]].double().mean(0)]))
    assert torch.allclose(got, want)


def test_judge_reads_zero_for_the_reference_and_more_for_faults():
    w, b, theta, idx = _xc()
    q = torch.randn(64, 12, generator=torch.Generator().manual_seed(6))
    lg, ids = heads.lss_topk(q, idx, w, None, 5)
    ok = judge.judge_lss(q.double(), idx, w, None, ids, lg.float())
    assert ok["hash_flip_margin"] == 0.0
    assert ok["rank_gap"] <= 1e-12 and ok["logit_err"] < 1e-6
    swapped = ids.clone()
    swapped[:, [0, 1]] = swapped[:, [1, 0]]
    assert judge.judge_lss(q.double(), idx, w, None, swapped)["rank_gap"] > 0
    other = ids.clone()
    other[0, 0] = int(idx.table[0, (idx.bucket_of[ids[0, 0], 0] + 1) % 16,
                                 0])
    bad = judge.judge_lss(q.double(), idx, w, None, other)
    assert bad["hash_flip_margin"] > 0.0
    missing = ids.clone()
    missing[3, 2] = -1
    assert judge.judge_lss(q.double(), idx, w, None,
                           missing)["rank_gap"] == math.inf
    full_lg, full_ids = heads.full_topk(q, w, b, 5)
    assert judge.judge_full(q.double(), w, b, full_ids,
                            full_lg.float())["rank_gap"] <= 1e-12


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, 1.0 + 2 ** -11 + 2 ** -20,
                      -3.0 - 2 ** -9 - 2 ** -13])
    got = common.round_tf32(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -10,
                            -3.0 - 2 ** -9]


def test_fp8_rows_is_lossy_but_close():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(7))
    y = common.fp8_rows(x)
    err = (y - x).abs().max() / x.abs().max()
    assert 0 < err < 0.1


def _tiny_cfg():
    return {"hidden_size": 16, "intermediate_size": 24,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "num_hidden_layers": 2, "head_dim": 4, "rms_norm_eps": 1e-6,
            "rope_theta": 10000.0, "vocab_size": 40,
            "tie_word_embeddings": True}


def _tiny_params(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    n, d, f = cfg["num_hidden_layers"], cfg["hidden_size"], \
        cfg["intermediate_size"]
    nq = cfg["num_attention_heads"] * cfg["head_dim"]
    nkv = cfg["num_key_value_heads"] * cfg["head_dim"]

    def r(*s, std=0.3):
        return torch.randn(*s, generator=g) * std

    return {"embed": r(cfg["vocab_size"], d, std=1.0),
            "final_norm": 1 + r(d, std=0.1),
            "layers": {"ln1": 1 + r(n, d, std=0.1), "ln2": 1 + r(n, d, std=0.1),
                       "wq": r(n, d, nq), "wk": r(n, d, nkv), "wv": r(n, d, nkv),
                       "bq": r(n, nq, std=0.05), "bk": r(n, nkv, std=0.05),
                       "bv": r(n, nkv, std=0.05), "wo": r(n, nq, d),
                       "w_gate": r(n, d, f), "w_up": r(n, d, f),
                       "w_down": r(n, f, d)}}


def _naive_qwen2(params, tokens, cfg):
    """Position by position, every earlier key: the definition."""
    d, h, kv = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    hd = cfg["head_dim"]
    eps = cfg["rms_norm_eps"]

    def rms(x, s):
        return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * s

    def rope(x, pos):
        inv = cfg["rope_theta"] ** (-torch.arange(0, hd, 2,
                                                  dtype=torch.float64) / hd)
        c, s = torch.cos(pos * inv), torch.sin(pos * inv)
        a, b2 = x[..., :hd // 2], x[..., hd // 2:]
        return torch.cat([a * c - b2 * s, b2 * c + a * s], -1)

    x = params["embed"][tokens].double()
    L = params["layers"]
    for i in range(cfg["num_hidden_layers"]):
        hh = rms(x, L["ln1"][i].double())
        q = (hh @ L["wq"][i].double() + L["bq"][i].double()).reshape(-1, h, hd)
        k = (hh @ L["wk"][i].double() + L["bk"][i].double()).reshape(-1, kv, hd)
        v = (hh @ L["wv"][i].double() + L["bv"][i].double()).reshape(-1, kv, hd)
        out = torch.zeros(len(tokens), h, hd, dtype=torch.float64)
        for t in range(len(tokens)):
            qt = rope(q[t], float(t))
            for head in range(h):
                g = head // (h // kv)
                ks = torch.stack([rope(k[j, g], float(j))
                                  for j in range(t + 1)])
                p = torch.softmax(ks @ qt[head] / math.sqrt(hd), 0)
                out[t, head] = p @ v[:t + 1, g]
        x = x + out.reshape(len(tokens), -1) @ L["wo"][i].double()
        hh = rms(x, L["ln2"][i].double())
        gate = hh @ L["w_gate"][i].double()
        x = x + (torch.nn.functional.silu(gate) * (hh @ L["w_up"][i].double())
                 ) @ L["w_down"][i].double()
    return rms(x, params["final_norm"].double())


def test_qwen2_blocks_match_the_definition():
    cfg = _tiny_cfg()
    params = _tiny_params(cfg)
    tokens = torch.tensor([3, 17, 5, 5, 39, 0, 12])
    got = qwen2.hidden_states(params, tokens, cfg, q_block=3)
    want = _naive_qwen2(params, tokens, cfg)
    assert torch.allclose(got.double(), want, rtol=1e-4, atol=1e-4)


def test_qwen2_fp8_control_departs():
    cfg = _tiny_cfg()
    params = _tiny_params(cfg)
    tokens = torch.tensor([3, 17, 5, 5, 39, 0, 12])
    a = qwen2.hidden_states(params, tokens, cfg)
    c = qwen2.hidden_states(params, tokens, cfg, precision="fp8")
    rel = ((a - c).norm() / a.norm()).item()
    assert 1e-3 < rel < 0.5


def test_qwen2_matches_the_port_at_float32():
    """Test-only cross-check: the port's train forward at float32 gives
    the same final hidden states."""
    from repro_torch.models import transformer as T
    cfg = _tiny_cfg()
    params = _tiny_params(cfg)
    tcfg = T.TransformerConfig(
        name="t", n_layers=2, d_model=16, n_heads=4, n_kv_heads=2,
        head_dim=4, d_ff=24, vocab=40, qkv_bias=True,
        rope_base=cfg["rope_theta"], tie_embeddings=True,
        dtype=torch.float32, remat=False)
    tokens = torch.tensor([[3, 17, 5, 5, 39, 0, 12]])
    with torch.no_grad():
        port, _, _ = T.forward(params, tokens, tcfg, mode="prefill")
    got = qwen2.hidden_states(params, tokens[0], cfg)
    assert torch.allclose(port[0], got, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [1, 2])
def test_program_xc_lss_matches_the_reference(seed):
    """Test-only: the port's LSS head (its plain path on the CPU) returns
    what the reference ranks, ids exact and logits within float32."""
    from repro_torch.core.lss import LSSConfig, build_index, lss_forward
    from repro_torch.core.simhash import augment_neurons
    w, b, theta, idx = _xc(seed)
    port_idx = build_index(augment_neurons(w, b), theta,
                           LSSConfig(k_bits=4, n_tables=1, capacity=40,
                                     slab_dtype="fp32"))
    assert torch.equal(port_idx.tables.table_ids.long(), idx.table)
    q = torch.relu(torch.randn(32, 12, generator=torch.Generator()
                               .manual_seed(seed + 10)))
    out = lss_forward(q, port_idx, None, 5)
    res = judge.judge_lss(q.double(), idx, w, None, out.top_ids,
                          out.top_logits)
    assert res["rank_gap"] < 1e-6 and res["logit_err"] < 1e-6
    assert np.isfinite(res["hash_flip_margin"])
