"""The frozen counts against worked small cases."""

import pytest

from wolbench.cost import breakdown, lm, peaks, xc


def test_bound_is_the_larger_of_bytes_and_operations():
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12) == pytest.approx(1.0)
    assert peaks.bound_s(1, 989e12, peaks.BF16_FLOPS) == pytest.approx(1.0)
    assert peaks.bound_s(6.7e12, 67e12) == pytest.approx(2.0)


def test_lss_topk_bytes_counts_each_distinct_slab_once():
    # 2 queries, d+1 = 3, K = 2, L = 1, P = 4; both hit one slab holding 3
    got = xc.lss_topk_bytes(2, 3, 2, 1, 4, distinct_slabs=1,
                            distinct_occupied=3, top_k=1)
    want = (1 * 4 * 4          # the slab's P ids
            + 3 * 3 * 4        # its 3 occupied rows of d+1 floats
            + 4 * 2 * 3        # the queries
            + 4 * 3 * 2        # theta
            + 4 * 2 * 4        # the candidate ids out
            + 8 * 2 * 1        # top-k logits and ids out
            + 4 * 2)           # sample sizes out
    assert got == want
    assert xc.lss_topk_flops(3, scored=6) == 36


def test_lss_topk_bound_at_delicious_widths():
    # 1,024 queries hit all 512 slabs of 808 slots, 401 occupied each
    b = xc.lss_topk_bound_s(1024, 129, 9, 1, 808, 512, 512 * 401,
                            1024 * 401, 5)
    nbytes = xc.lss_topk_bytes(1024, 129, 9, 1, 808, 512, 512 * 401, 5)
    assert nbytes > 512 * 401 * 129 * 4
    assert b == pytest.approx(nbytes / peaks.HBM_BYTES_PER_S)


def test_full_step_is_compute_bound_at_delicious_widths():
    flops = xc.batch_flops(1024, 1024 * 64, 128, "full", m=205443)
    assert flops == 1024 * 64 * 128 + 1024 * (2 * 128 * 205443 + 205443)
    b = xc.full_step_bound_s(1024, 64, 1024 * 64, 50000, 128, 205443, 5)
    assert b == pytest.approx(flops / peaks.FP32_FLOPS)
    assert xc.full_step_bytes(2, 3, 4, 5, 6, 1) == \
        4 * 2 * 3 + 4 * 4 * 5 + 4 * 6 * 5 + 4 * 6 + 8 * 2


def test_lss_batch_flops():
    # 2 rows, 5 features, d = 3, K = 2: bag 15, hash 2*4*2 a row, 7 slots
    assert xc.batch_flops(2, 5, 3, "lss", k_bits=2, n_tables=1,
                          scored=7) == 15 + 2 * 16 + 2 * 4 * 7


QWEN = {"hidden_size": 896, "intermediate_size": 4864,
        "num_attention_heads": 14, "num_key_value_heads": 2,
        "num_hidden_layers": 24, "head_dim": 64}


def test_qwen2_linear_params():
    per_layer = 896 * 896 * 2 + 2 * 896 * 128 + 3 * 896 * 4864
    assert lm.linear_params(QWEN) == 24 * per_layer == 357_826_560


def test_decode_and_prefill_flops():
    cfg = {"hidden_size": 4, "intermediate_size": 6,
           "num_attention_heads": 2, "num_key_value_heads": 1,
           "num_hidden_layers": 1, "head_dim": 2}
    lin = 4 * 4 + 2 * 4 * 2 + 4 * 4 + 3 * 4 * 6          # 120
    assert lm.linear_params(cfg) == lin
    head = 2 * 5 * 3 + 2 * 5 * 10                          # K = 3, 10 slots
    assert lm.decode_token_flops(cfg, 7, 3, 1, 10) == \
        2 * lin + 4 * 1 * 2 * 2 * 7 + head
    assert lm.prefill_flops(cfg, 3, 3, 1, 10) == \
        2 * lin * 3 + 4 * 1 * 2 * 2 * 6 + head


def test_breakdown_busy_union_and_gaps():
    recs = [(False, "outer", 0, 100, 1), (False, "inner", 10, 40, 1),
            (True, "k1", 20, 30, 0), (True, "k2", 25, 50, 0),
            (True, "k3", 70, 80, 0), (False, "t2", 55, 65, 2),
            (True, "ann", 0, 1, 0)]
    w = breakdown.reduce_window(recs[:-1])
    assert w["window_s"] == pytest.approx(100e-9)
    assert w["busy_s"] == pytest.approx(40e-9)          # 20-50 and 70-80
    assert w["device_ops"][0] == ["k2", pytest.approx(25e-9)]
    gaps = dict((n, s) for n, s in w["idle_gaps"])
    # 0-20 (inner holds 10), 50-70 (t2 holds 60), 80-100 (outer holds 90)
    assert gaps == {"inner": pytest.approx(20e-9), "t2": pytest.approx(20e-9),
                    "outer": pytest.approx(20e-9)}
    host = dict((n, s) for n, s in w["host_self"])
    assert host["outer"] == pytest.approx(70e-9)


def test_breakdown_of_nothing():
    w = breakdown.reduce_window([])
    assert w["busy_s"] == 0.0 and w["device_ops"] == []


def test_breakdown_keeps_ten():
    recs = [(True, f"k{i}", i * 10, i * 10 + i + 1, 0) for i in range(15)]
    w = breakdown.reduce_window(recs)
    assert len(w["device_ops"]) == 10
    assert w["device_ops"][0][0] == "k14"
