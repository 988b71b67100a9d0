"""``decode_attn_roofline``: the decode-attention kernel's share of its
roofline over the profiled window.  The bound: every token that reached
its stream in the window after its first (a decode step made it) reads
the K and V of its context once, ``plen + j`` positions for token j, in
every layer, at the HBM bandwidth; the kernel's own bytes (its split
workspace, the table) and the steps whose tokens land outside the window
are left out, so the share stays under 100%.  The time: the device time
of every op whose name holds ``decode_attn`` (the kernel's split and
merge passes).  None where no such op ran: a program without the kernel,
a run on the CPU, an untraced run."""

import numpy as np

from wolbench.cost import peaks
from wolbench.harness.profiling import device_window
from wolbench.harness.window import stream_token_times

STEM = "decode_attn"
_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def kv_bytes_per_position(cfg: dict) -> int:
    """K and V of one position in every layer, in the cache's type."""
    hd = cfg.get("head_dim") or cfg["hidden_size"] // cfg[
        "num_attention_heads"]
    return (cfg["num_hidden_layers"] * 2 * cfg["num_key_value_heads"] * hd
            * _BYTES[cfg["torch_dtype"]])


def read(ctx):
    w = device_window(ctx)
    if w is None or ctx.kind != "lm":
        return None
    names = [n for n in w["device_ns"] if STEM in n]
    kernel_s = sum(w["device_ns"][n] for n in names) / 1e9
    if not kernel_s:
        return None
    a, b = ctx.prof.t0, ctx.prof.t1
    positions = 0
    for s in ctx.sessions:
        times = stream_token_times(s.record)
        inside = np.flatnonzero((times >= a) & (times <= b))
        inside = inside[inside >= 1]
        positions += int((len(s.prompt) + inside).sum())
    if not positions:
        return None
    bound_s = (positions * kv_bytes_per_position(ctx.cfg)
               / peaks.HBM_BYTES_PER_S)
    return 100.0 * bound_s / kernel_s
