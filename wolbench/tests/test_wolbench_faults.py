"""A run with the timed path broken underneath must come out not correct,
and the control must fail the limits: every cell at a tiny size on the
CPU (the look for a card skipped), with the cells' own limits.

Faults each cell can have (one card, so no exchange between chips):
an answer or a token altered where the head produces it, half of the
batch left out (its rows answered with the other half's), and for
decode a step that leaves its state (the KV cache) unchanged.  The
control at each cell's own size is read on the card by
``wolbench/control.py``; here it runs at the tiny size."""

import pytest
import torch

from wolbench import control
from wolbench import run as bench_run
from wolbench.tests.tiny import TinyCell

XC_CELLS = ["xc-lss-bulk", "xc-full-bulk"]
LM_CELLS = ["qwen2-0.5b-lss-reason", "qwen2-0.5b-lss-chat"]


def _correct(cell, res) -> bool:
    return bench_run.verdict(res, bench_run.checks_of(cell, res))


@pytest.mark.parametrize("name", XC_CELLS + LM_CELLS)
def test_a_sound_run_is_correct(name):
    cell = TinyCell(name)
    res = cell.run()
    assert res["compared"] > 0
    assert _correct(cell, res), res["checks"]


def _alter_head(monkeypatch):
    """Every head's first answer moved to the next neuron."""
    from repro_torch.serve import heads

    lss, topk = heads.lss_forward, heads.topk_lowest_index

    def lss_forward(*a, **k):
        out = lss(*a, **k)
        ids = out.top_ids.clone()
        ids[:, 0] = ids[:, 0] + 1
        return out._replace(top_ids=ids)

    def topk_lowest_index(x, k):
        vals, idx = topk(x, k)
        idx = idx.clone()
        idx[:, 0] = idx[:, 0] + 1
        return vals, idx

    monkeypatch.setattr(heads, "lss_forward", lss_forward)
    monkeypatch.setattr(heads, "topk_lowest_index", topk_lowest_index)


def _half_batch(monkeypatch):
    """A batch's second half answered with its first half's answers."""
    from repro_torch.serve import heads

    lss, topk = heads.lss_forward, heads.topk_lowest_index

    def copy_half(t):
        n = t.shape[0] // 2
        if n == 0:
            return t
        t = t.clone()
        t[n:2 * n] = t[:n]
        return t

    def lss_forward(*a, **k):
        out = lss(*a, **k)
        return out._replace(top_ids=copy_half(out.top_ids),
                            top_logits=copy_half(out.top_logits))

    def topk_lowest_index(x, k):
        vals, idx = topk(x, k)
        return copy_half(vals), copy_half(idx)

    monkeypatch.setattr(heads, "lss_forward", lss_forward)
    monkeypatch.setattr(heads, "topk_lowest_index", topk_lowest_index)


def _state_unchanged(monkeypatch):
    """The decode step writes nothing into the paged KV arenas."""
    from repro_torch.models import transformer as T

    step = T.decode_step_paged

    def decode_step_paged(params, token, k_arena, v_arena, *rest):
        k0, v0 = k_arena.clone(), v_arena.clone()
        out = step(params, token, k_arena, v_arena, *rest)
        k_arena.copy_(k0)
        v_arena.copy_(v0)
        return out

    monkeypatch.setattr(T, "decode_step_paged", decode_step_paged)


FAULTS = {"answer altered": _alter_head, "half the batch": _half_batch}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", XC_CELLS + LM_CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    cell = TinyCell(name)
    res = cell.run()
    assert not _correct(cell, res), res["checks"]


@pytest.mark.parametrize("name", LM_CELLS)
def test_a_decode_step_that_keeps_its_state_is_not_correct(name,
                                                           monkeypatch):
    _state_unchanged(monkeypatch)
    cell = TinyCell(name)
    res = cell.run()
    assert not _correct(cell, res), res["checks"]


@pytest.mark.parametrize("name", XC_CELLS + LM_CELLS)
def test_the_control_fails_the_limits(name):
    cell = TinyCell(name)
    res = cell.run(seconds=2.0, control=True)
    assert _correct(cell, res), res["checks"]
    ctrl_ok, ctrl_checks = control.control_verdict(cell, res)
    assert ctrl_checks and not ctrl_ok, ctrl_checks


def test_a_control_that_gives_no_number_is_not_correct():
    cell = TinyCell("xc-lss-bulk")
    res = {"compared": 3, "failed": 0, "failures": [], "checks": {},
           "control_checks": None}
    assert control.control_verdict(cell, res) == (False, {})


def test_a_traced_run_reads_the_spans():
    cell = TinyCell("qwen2-0.5b-lss-chat")
    res = cell.run(trace=True)
    from wolbench.harness import spec
    ctx = res["ctx"]
    assert spec.reader("tick_ms.decode")(ctx) > 0
    assert spec.reader("prefill_ms.chat")(ctx) > 0
    # the CPU has no device records: the device readers find nothing
    assert spec.reader("device_idle_pct.chat")(ctx) is None
    assert spec.reader("mfu.chat")(ctx) is None


def test_an_xc_traced_run_reads_its_calls():
    cell = TinyCell("xc-lss-bulk")
    res = cell.run(trace=True)
    from wolbench.harness import spec
    ctx = res["ctx"]
    assert spec.reader("rank_ms.xc")(ctx) > 0
    assert spec.reader("lss_topk_roofline")(ctx) is None
    assert spec.reader("device_idle_pct.xc")(ctx) is None
    assert torch.is_tensor(ctx.params["w_out"])
