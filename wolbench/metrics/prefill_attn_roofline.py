"""``prefill_attn_roofline``: the prefill-attention kernel's share of its
roofline over the profiled window.  The bound: every prompt whose
``prefill`` span lies wholly inside the window and ran a forward (a
``prefill.forward`` span under it; a prompt joined from the prefix cache
runs none) is attended at the width S its forward ran at, the span's
``bucket`` (the padded prompt), in every layer:
``4 * layers * N * H * S(S+1)/2`` operations at the bf16 tensor cores'
peak; a span without ``bucket`` counts nothing.  The time: the device time of every op whose name holds
``prefill_attn``, over the whole window, so prefills cut by its edges
count in the time and not in the bound, and the share stays under the
true one.  None where no such op ran: a program without the kernel, a
run on the CPU, an untraced run."""

from wolbench.cost import peaks
from wolbench.harness.profiling import device_window
from wolbench.harness.spans import program_spans

STEM = "prefill_attn"


def causal_flops(cfg: dict, s: int) -> float:
    """q.k and p.v over the S(S+1)/2 causal (query, key) pairs of every
    layer and query head."""
    hd = cfg.get("head_dim") or cfg["hidden_size"] // cfg[
        "num_attention_heads"]
    return (4.0 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] * hd
            * s * (s + 1) / 2)


def read(ctx):
    w = device_window(ctx)
    if w is None or ctx.kind != "lm":
        return None
    kernel_s = sum(ns for n, ns in w["device_ns"].items() if STEM in n) / 1e9
    if not kernel_s:
        return None
    a, b = ctx.prof.t0, ctx.prof.t1
    spans = program_spans(ctx)
    forwards = {s.args.get("parent") for s in spans
                if s.name == "prefill.forward"}
    flops = sum(causal_flops(ctx.cfg, int(s.args["bucket"]))
                for s in spans if s.name == "prefill" and s.sid in forwards
                and "bucket" in s.args and a <= s.t0 and s.t1 <= b)
    if not flops:
        return None
    return 100.0 * flops / peaks.BF16_FLOPS / kernel_s
