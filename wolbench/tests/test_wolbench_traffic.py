"""Traffic and window arithmetic on the CPU: the same seed gives the same
work, drawn lengths keep to the mix, a stall shows in every end-to-end
number it should move, and the harness will not measure without a card."""

import json
import subprocess
import sys

import numpy as np
import pytest

from wolbench.harness import spec
from wolbench.harness.window import (StreamRecord, bulk_window,
                                     decode_window, p95)
from wolbench.traffic import generator as gen

MIXES = ["lss-bulk", "full-bulk", "lss-reason", "lss-chat"]


def _small(mix: dict) -> dict:
    """The mix with its pool cut, so the test draws it quickly."""
    out = dict(mix)
    if mix["kind"] == "bulk":
        out.update(pool_batches=3)
    else:
        out.update(pool_sessions=2 * mix["clients"])
    return out


@pytest.mark.parametrize("name", MIXES)
def test_every_mix_loads_by_name(name):
    mix = gen.load(name)
    assert mix["kind"] in ("bulk", "sessions") and mix["head"] in (
        "lss", "full")


def test_an_unknown_mix_is_refused():
    with pytest.raises(KeyError):
        gen.load("no-such-mix")


def test_same_seed_same_batches_and_other_seed_other_rows():
    mix = _small(gen.load("lss-bulk"))
    a = gen.bow_pool(mix, 782585, 64, seed=2 ** 31 + 7)
    b = gen.bow_pool(mix, 782585, 64, seed=2 ** 31 + 7)
    c = gen.bow_pool(mix, 782585, 64, seed=5)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.shape == (3, 1024, 64) and a.dtype == np.int32


def test_bulk_rows_keep_to_the_mix_and_every_batch_has_the_same_spread():
    mix = _small(gen.load("lss-bulk"))
    lo, hi = mix["features"]
    pool = gen.bow_pool(mix, 782585, 64, seed=11)
    counts = (pool >= 0).sum(-1)
    assert counts.min() >= lo and counts.max() <= hi
    # valid features first, then padding
    assert np.all((pool >= 0)[..., :lo])
    assert np.all(pool < 782585)
    assert np.array_equal(np.sort(counts[0]), np.sort(counts[1]))
    other = gen.bow_pool(mix, 782585, 64, seed=12)
    assert np.array_equal(np.sort((other >= 0).sum(-1)[0]),
                          np.sort(counts[0]))


@pytest.mark.parametrize("name", ["lss-reason", "lss-chat"])
def test_sessions_same_seed_and_lengths_in_range(name):
    mix = _small(gen.load(name))
    a = gen.session_plan(mix, 151936, seed=2 ** 31 + 9)
    b = gen.session_plan(mix, 151936, seed=2 ** 31 + 9)
    assert all(np.array_equal(p, q) and n == m
               for (p, n), (q, m) in zip(a, b))
    p_lo, p_hi = mix["prompt_tokens"]
    o_lo, o_hi = mix["output_tokens"]
    clients = mix["clients"]
    assert all(p_lo <= len(p) <= p_hi for p, _ in a)
    assert all(0 <= t < 151936 for p, _ in a for t in p[:5])
    # the first wave asks for a share of its drawn length
    assert all(1 <= n <= o_hi for _, n in a[:clients])
    assert all(o_lo <= n <= o_hi for _, n in a[clients:])
    # another seed: the same lengths in another order
    c = gen.session_plan(mix, 151936, seed=3)
    assert sorted(len(p) for p, _ in a[clients:]) == \
        sorted(len(p) for p, _ in c[clients:])
    assert sorted(n for _, n in a[clients:]) == \
        sorted(n for _, n in c[clients:])


def test_stratified_spreads_evenly():
    v = gen.stratified(3072, 5120, 64, np.random.default_rng(0))
    assert v.min() >= 3072 and v.max() <= 5120
    assert abs(np.mean(v) - (3072 + 5120) / 2) < 20
    assert len(set(v.tolist())) == 64


def test_prefill_buckets_cover_the_prompts():
    assert gen.prefill_buckets(128, 512) == [128, 256, 512]
    assert gen.prefill_buckets(1024, 4096) == [1024, 2048, 4096]
    assert gen.prefill_buckets(100, 500) == [128, 256, 512]
    assert gen.prefill_buckets(3, 5) == [8]


def test_a_stall_lowers_queries_per_s():
    steady = [(i * 0.01, i * 0.01 + 0.005, 1024) for i in range(100)]
    stalled = [(t0 + (0.3 if t0 >= 0.5 else 0), t1
                + (0.3 if t0 >= 0.5 else 0), r) for t0, t1, r in steady]
    a = bulk_window(steady, 0.0, 1.0)
    b = bulk_window(stalled, 0.0, 1.0)
    assert a["rows"] == 100 * 1024 and a["queries_per_s"] == 102400
    assert b["queries_per_s"] < a["queries_per_s"]


def _streams(stall_at=None, stall=0.0):
    out = []
    for s in range(8):
        gaps = np.full(199, 0.01)
        if stall_at is not None:
            gaps[stall_at + s] += stall
        out.append(StreamRecord(t_submit=0.0, ttft_s=0.05, gaps_s=gaps))
    return out


def test_a_stall_lowers_tokens_per_s_and_raises_itl_p95():
    a = decode_window(_streams(), 0.0, 1.5)
    b = decode_window(_streams(stall_at=10, stall=0.2), 0.0, 1.5)
    assert b["tokens_per_s"] < a["tokens_per_s"]
    assert a["itl_p95_ms"] == pytest.approx(10.0)
    many = decode_window([StreamRecord(0.0, 0.05, np.where(
        np.arange(199) % 10 == 0, 0.2, 0.01))] * 8, 0.0, 1.5)
    assert many["itl_p95_ms"] > a["itl_p95_ms"]
    assert a["ttft_p95_ms"] == pytest.approx(50.0)
    assert a["first_tokens"] == 8


def test_window_counts_only_what_landed_inside():
    rec = StreamRecord(0.0, 0.5, np.full(9, 0.1))         # 0.5 .. 1.4
    w = decode_window([rec], 0.95, 2.0)
    assert w["tokens"] == 5 and w["gaps"] == 5 and w["first_tokens"] == 0
    assert w["ttft_p95_ms"] is None
    assert p95([]) is None


def test_the_benchmark_names_resolve():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        assert cell.chips == 1
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"]))
            assert m["moves"] in names


def test_a_metric_without_a_file_of_its_own_reads_its_quantity():
    assert spec.reader("device_idle_pct.xc") is not None
    assert spec.reader("device_idle_pct.some_later_group").__module__ == \
        spec.reader("device_idle_pct").__module__
    with pytest.raises(KeyError):
        spec.reader("no_such_quantity.xc")


def test_no_card_no_result():
    """The harness refuses to measure on a machine without a card: a
    nonzero exit and nothing on standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot show")
    out = subprocess.run(
        [sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
         "xc-lss-bulk", "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: no result."""
    import shutil
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "wolbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, str(tmp_path / "wolbench" / "run.py"),
         "--workload", "xc-lss-bulk", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=tmp_path, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    json.loads((tmp_path / "BENCHMARK.json").read_text())
