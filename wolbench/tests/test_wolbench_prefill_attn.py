"""``prefill_attn_roofline`` on a synthetic profiled window and span ring
against a hand count, and None wherever no ``prefill_attn`` op ran."""

import json
from types import SimpleNamespace

import pytest

from wolbench.cost import peaks
from wolbench.harness import spec
from wolbench.harness.spans import Rec

CFG = json.loads((spec.BENCH_DIR / "configs" / "qwen2-0.5b.json").read_text())
READ = spec.reader("prefill_attn_roofline")
FLOPS_AT = {s: 4.0 * 24 * 14 * 64 * s * (s + 1) / 2       # layers, N, H
            for s in (8, 1024, 2048, 4096)}


def _prefill(sid, t0, ms, plen, bucket, forward=True):
    args = {"sid": sid, "plen": plen}
    if bucket is not None:                  # the program's padded width
        args["bucket"] = bucket
    recs = [Rec("prefill", t0, t0 + ms / 1e3, args, 100 + sid)]
    if forward:
        recs.append(Rec("prefill.forward", t0, t0 + 0.9 * ms / 1e3,
                        {"parent": 100 + sid}, 200 + sid))
    return recs


def _ring():
    return (_prefill(0, 9.9, 200.0, 1024, 1024)  # began before the window
            + _prefill(1, 11.0, 250.0, 4096, 4096)   # bucket 4,096
            + _prefill(2, 12.0, 150.0, 1025, 2048)   # bucket 2,048
            + _prefill(3, 13.0, 100.0, 1024, 1024)   # bucket 1,024
            + _prefill(4, 14.0, 1.0, 3, 8, forward=False)  # from the cache
            + _prefill(5, 15.0, 5.0, 3, 8)           # floor 8
            + _prefill(6, 19.9, 250.0, 4096, 4096))  # ends after the window


def _ctx(device_ns, kind="lm", busy_s=1.0, recs=None):
    window = {"window_s": 10.0, "busy_s": busy_s, "device_ns": device_ns,
              "device_count": {n: 1 for n in device_ns}}
    return SimpleNamespace(kind=kind, cfg=CFG, window=(10.0, 20.0),
                           _program_spans=_ring() if recs is None else recs,
                           prof=SimpleNamespace(t0=10.0, t1=20.0,
                                                window=window))


KERNEL = ("void (anonymous namespace)::prefill_attn_bf16_kernel<64>"
          "(...)")
OTHERS = {"nvjet_tst_128x64_64x4_1x2_h_bz_TNT": 9_000_000,
          "void (anonymous namespace)::decode_attn_split_kernel"
          "<__nv_bfloat16, 64, 8>(...)": 2_000_000}


def test_the_bound_counts_whole_prefills_at_their_bucket():
    flops = (FLOPS_AT[4096] + FLOPS_AT[2048] + FLOPS_AT[1024]
             + FLOPS_AT[8])
    bound_s = flops / peaks.BF16_FLOPS
    ctx = _ctx({KERNEL: 3_000_000, **OTHERS})            # 3 ms
    assert READ(ctx) == pytest.approx(100.0 * bound_s / 3e-3, rel=1e-12)


def test_under_100_when_the_kernel_takes_exactly_the_bound():
    """The window's prefills (whole and cut) all ran the kernel; at
    exactly the bound for each, the cut ones' time keeps it under 100%."""
    whole = (FLOPS_AT[4096] + FLOPS_AT[2048] + FLOPS_AT[1024] + FLOPS_AT[8])
    cut = FLOPS_AT[1024] + FLOPS_AT[4096]       # sids 0 and 6
    ns = (whole + cut) / peaks.BF16_FLOPS * 1e9
    share = READ(_ctx({KERNEL: ns}))
    assert share == pytest.approx(100.0 * whole / (whole + cut), rel=1e-9)
    assert share < 100.0
    ns = whole / peaks.BF16_FLOPS * 1e9         # no prefill cut
    assert READ(_ctx({KERNEL: ns})) == pytest.approx(100.0, rel=1e-9)


@pytest.mark.parametrize("case", ["no_kernel", "no_profile", "idle", "xc",
                                  "no_prefill", "only_cut", "no_bucket"])
def test_none_where_nothing_was_read(case):
    if case == "no_kernel":                    # the program without it
        ctx = _ctx(OTHERS)
    elif case == "no_profile":                 # untraced
        ctx = _ctx({KERNEL: 1})
        ctx.prof = None
    elif case == "idle":                       # a run on the CPU
        ctx = _ctx({}, busy_s=0.0)
    elif case == "xc":
        ctx = _ctx({KERNEL: 1}, kind="xc")
    elif case == "no_prefill":
        ctx = _ctx({KERNEL: 1}, recs=_prefill(4, 14.0, 1.0, 3, 8,
                                              forward=False))
    elif case == "only_cut":
        ctx = _ctx({KERNEL: 1}, recs=_prefill(0, 9.9, 200.0, 1024, 1024)
                   + _prefill(6, 19.9, 250.0, 4096, 4096))
    else:                                      # spans without the width
        ctx = _ctx({KERNEL: 1}, recs=_prefill(1, 11.0, 250.0, 4096, None))
    assert READ(ctx) is None
