"""The readers of the program's spans: on synthetic rings with known
answers, on a ring of a program without the spans (they find nothing),
and on tiny traced runs of each cell on the CPU."""

from types import SimpleNamespace

import numpy as np
import pytest

from wolbench.harness import spec
from wolbench.harness.spans import Rec
from wolbench.tests.tiny import TinyCell

WINDOW = (10.0, 20.0)


def _ctx(recs, window=WINDOW, prof=None):
    """A context whose ring is ``recs`` (the readers' cache preset)."""
    return SimpleNamespace(window=window, prof=prof, _program_spans=recs)


def _rec(name, t0, ms, span_id=None, **args):
    return Rec(name, t0, t0 + ms / 1e3, args, span_id)


def _xc_ring():
    recs = []
    for i, t in enumerate((9.0, 11.0, 12.0, 13.0)):   # the first: before
        r = 10 * i
        recs += [_rec("rank", t, 0.6, r, rows=1024, bucket=1024),
                 _rec("step.copy_in", t, 0.1 + i / 100, r + 1, parent=r,
                      pinned=1),
                 _rec("step.replay", t + 1e-4, 0.04, r + 2, parent=r),
                 _rec("step.clone", t + 2e-4, 0.02, r + 3, parent=r),
                 _rec("output.copy", t + 7e-4, 0.05, r + 4, pinned=2),
                 _rec("output.wait", t + 8e-4, 0.03 + i / 100, r + 5)]
    # a step's copy-in that no rank holds: the decode step's
    recs += [_rec("tick.dispatch", 14.0, 1.0, 100),
             _rec("step.copy_in", 14.0, 9.0, 101, parent=100, pinned=2)]
    return recs


def test_the_rank_phases_read_inside_rank_spans_in_the_window():
    ctx = _ctx(_xc_ring())
    read = {m: spec.reader(m)(ctx) for m in (
        "copy_in_ms.xc", "replay_ms.xc", "wait_ms.xc", "pinned_buffers.xc")}
    assert read["copy_in_ms.xc"] == pytest.approx(0.12)   # 0.11, .12, .13
    assert read["replay_ms.xc"] == pytest.approx(0.04)
    assert read["wait_ms.xc"] == pytest.approx(0.05)      # .04, .05, .06
    # the stray copy-in pins 2 more: (3 x 1 + 3 x 2 + 2) / 3 ranks
    assert read["pinned_buffers.xc"] == pytest.approx(11 / 3)
    without = _ctx([r for r in _xc_ring() if r.name != "tick.dispatch"
                    and not (r.name == "step.copy_in" and r.t0 == 14.0)])
    assert spec.reader("pinned_buffers.xc")(without) == pytest.approx(3.0)


def test_the_decode_readers():
    recs = [_rec("tick", 11.0 + i, 30.0, 10 * i, active=a, slots=64)
            for i, a in enumerate((64, 48, 32))]
    recs += [_rec("tick.dispatch", 11.0 + i, d, 10 * i + 1, parent=10 * i)
             for i, d in enumerate((0.3, 0.5, 0.4))]
    recs += [_rec("tick.collect", 11.01 + i, c, 10 * i + 2, parent=10 * i)
             for i, c in enumerate((29.0, 28.0, 30.0))]
    recs += [_rec("tick", 25.0, 30.0, 99, active=0, slots=64)]  # after
    ctx = _ctx(recs)
    assert spec.reader("dispatch_ms.decode")(ctx) == pytest.approx(0.4)
    assert spec.reader("collect_ms.decode")(ctx) == pytest.approx(29.0)
    assert spec.reader("slot_occupancy.decode")(ctx) == pytest.approx(
        100 * (64 + 48 + 32) / (3 * 64))


def test_the_queue_p90_counts_the_waits_that_ended_in_the_window():
    waits = [5.0, 50.0, 100.0, 150.0, 200.0, 250.0, 300.0, 350.0, 400.0,
             450.0, 500.0]
    recs = [_rec("queue", 12.0, w, i, sid=i) for i, w in enumerate(waits)]
    recs += [_rec("queue", 9.9, 200.0, 50, sid=50),     # began before
             _rec("queue", 19.9, 200.0, 51, sid=51)]    # ended after
    recs += [_rec("prefill.forward", 12.0 + i, f, 60 + i)
             for i, f in enumerate((150.0, 250.0, 200.0))]
    ctx = _ctx(recs)
    want = np.percentile(waits + [200.0], 90)
    assert spec.reader("queue_p90_ms.chat")(ctx) == pytest.approx(want)
    assert spec.reader("prefill_forward_ms.chat")(ctx) == pytest.approx(
        200.0)


def test_the_unowned_idle_share_reads_the_idle_owner():
    def prof(gaps):
        return SimpleNamespace(window={"busy_s": 1.0, "window_s": 5.0,
                                       "idle_gaps": gaps})

    read = spec.reader("device_idle_unowned_pct.xc")
    assert read(_ctx([], prof=prof([["rank", 2.0], ["idle", 0.5]]))) == \
        pytest.approx(10.0)
    assert read(_ctx([], prof=prof([["rank", 2.0]]))) == 0.0
    assert read(_ctx([], prof=None)) is None
    assert spec.reader("device_idle_unowned_pct.chat")(
        _ctx([], prof=prof([["idle", 1.0]]))) == pytest.approx(20.0)


NEW = ["copy_in_ms.xc", "replay_ms.xc", "wait_ms.xc", "pinned_buffers.xc",
       "dispatch_ms.decode", "collect_ms.decode", "slot_occupancy.decode",
       "queue_p90_ms.chat", "prefill_forward_ms.chat"]


def test_a_program_without_the_spans_gives_nothing():
    """The spans a program had before these readers: ``tick`` without
    ``slots``, ``prefill`` whole, no ``rank`` and no ``step.*``."""
    ctx = _ctx([_rec("tick", 11.0, 30.0, 1, active=64),
                _rec("prefill", 12.0, 260.0, 2, sid=0, slot=0, plen=2048),
                _rec("decode_session", 11.5, 900.0, 3, sid=0)])
    for name in NEW:
        assert spec.reader(name)(ctx) is None, name


@pytest.mark.parametrize("name", ["xc-lss-bulk", "xc-full-bulk"])
def test_an_xc_traced_run_reads_its_spans(name):
    cell = TinyCell(name)
    ctx = cell.run(trace=True)["ctx"]
    assert spec.reader("copy_in_ms.xc")(ctx) > 0
    assert spec.reader("wait_ms.xc")(ctx) > 0
    # the CPU's step is eager: no graph to replay, no buffer pinned
    assert spec.reader("replay_ms.xc")(ctx) is None
    assert spec.reader("pinned_buffers.xc")(ctx) == 0.0
    assert spec.reader("device_idle_unowned_pct.xc")(ctx) is None


def test_a_decode_traced_run_reads_its_spans():
    ctx = TinyCell("qwen2-0.5b-lss-reason").run(trace=True)["ctx"]
    assert spec.reader("dispatch_ms.decode")(ctx) > 0
    assert spec.reader("collect_ms.decode")(ctx) > 0
    assert 0 < spec.reader("slot_occupancy.decode")(ctx) <= 100


def test_a_chat_traced_run_reads_its_spans():
    ctx = TinyCell("qwen2-0.5b-lss-chat").run(trace=True)["ctx"]
    assert spec.reader("queue_p90_ms.chat")(ctx) >= 0
    forward = spec.reader("prefill_forward_ms.chat")(ctx)
    assert 0 < forward <= spec.reader("prefill_ms.chat")(ctx)
    assert spec.reader("device_idle_unowned_pct.chat")(ctx) is None
