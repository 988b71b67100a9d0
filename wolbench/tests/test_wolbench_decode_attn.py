"""``decode_attn_roofline`` on a synthetic profiled window against a hand
count, and None wherever no ``decode_attn`` op ran."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from wolbench.cost import peaks
from wolbench.harness import spec
from wolbench.harness.window import StreamRecord

CFG = json.loads((spec.BENCH_DIR / "configs" / "qwen2-0.5b.json").read_text())
READ = spec.reader("decode_attn_roofline")


def _session(plen, t_submit, ttft, gaps):
    return SimpleNamespace(prompt=np.zeros(plen, np.int32),
                           record=StreamRecord(t_submit, ttft,
                                               np.asarray(gaps, float)))


def _ctx(device_ns, kind="lm", busy_s=1.0):
    window = {"window_s": 10.0, "busy_s": busy_s, "device_ns": device_ns,
              "device_count": {n: 1 for n in device_ns}}
    sessions = [
        # tokens at 9.5 + j: j = 1..10 land in [10, 20]; j = 0 and 11 not
        _session(100, 9.0, 0.5, [1.0] * 11),
        # its first token lands inside but carries prefill: only j = 1..3
        _session(50, 12.0, 0.25, [2.0] * 3),
        # nothing in the window yet
        _session(70, 19.9, None, []),
    ]
    return SimpleNamespace(kind=kind, cfg=CFG, sessions=sessions,
                           prof=SimpleNamespace(t0=10.0, t1=20.0,
                                                window=window))


KERNELS = {"void (anonymous namespace)::decode_attn_split_kernel"
           "<__nv_bfloat16, 64, 8>(...)": 3_000_000,
           "void (anonymous namespace)::decode_attn_merge_kernel"
           "<__nv_bfloat16>(...)": 1_000_000,
           "nvjet_tst_64x8_64x16_4x1_v_bz_TNT": 5_000_000}


def test_bound_over_the_kernels_device_time_by_hand():
    positions = sum(100 + j for j in range(1, 11)) + (51 + 52 + 53)
    assert positions == 1211
    per_position = 24 * 2 * 2 * 64 * 2         # layers, K and V, KV, H, bf16
    bound_s = positions * per_position / peaks.HBM_BYTES_PER_S
    want = 100.0 * bound_s / 4e-3              # split + merge: 4 ms
    assert READ(_ctx(KERNELS)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("case", ["no_kernel", "no_profile", "idle", "xc",
                                  "no_tokens"])
def test_none_where_nothing_was_read(case):
    others = {k: v for k, v in KERNELS.items() if "decode_attn" not in k}
    if case == "no_kernel":                    # the program without it
        ctx = _ctx(others)
    elif case == "no_profile":                 # untraced
        ctx = _ctx(KERNELS)
        ctx.prof = None
    elif case == "idle":                       # a run on the CPU
        ctx = _ctx({}, busy_s=0.0)
    elif case == "xc":
        ctx = _ctx(KERNELS, kind="xc")
    else:
        ctx = _ctx(KERNELS)
        ctx.sessions = ctx.sessions[2:]
    assert READ(ctx) is None
