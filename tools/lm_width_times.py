#!/usr/bin/env python3
"""Device times of the port's ``lss_topk`` and ``simhash_codes`` at every
LM width of the arch registry, to compare copies of the tree on one card.

Imports the port and ``chip_smoke.time_ms`` (median of 20 launches, each
after an L2 flush) from TREE, a copy of the repository (a ``git archive``
unpacked under ``build/``, say), builds TREE's kernels, holds each case
against its plain version (ids exact, logits within 1e-4; codes exact on
the rows whose hash margin holds) and prints one JSON line of device ms:

* ``lss_topk`` at the main path's shape (d = 129, K = 9, L = 1, P = 808,
  B = 256, fp32 slabs of a random index over 205,443 rows), the layout
  that must not move when a wider one is added;
* ``lss_topk`` at each LSS head of the registry's LMs (d_model + 1 and
  the arch's K, L and capacity; each slot a random id), fp32, bf16 and
  int8 slabs, B = 8 and 1, with the layout taken (narrow or wide);
* ``simhash_codes`` at each of those widths, B = 256 and 4,096.

A case TREE refuses (a ``ValueError``: an older tree's width limit) is
reported as ``refused``.  Run from the repository root on a machine with
one CUDA device, one process per tree (each loads its own kernels)::

    python3 tools/lm_width_times.py --tree build/variant --label variant
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

SEED = 0
LM_ARCHS = ("qwen2-0.5b", "qwen2-moe-a2.7b", "qwen3-4b", "qwen2-7b",
            "arctic-480b")
# the registry's LSS configs, so that a tree without the zoo's configs
# is timed at the same shapes: arch -> (d_model, vocab, K, L)
HEADS = {"qwen2-0.5b": (896, 151936, 10, 1),
         "qwen2-moe-a2.7b": (2048, 151936, 10, 1),
         "qwen3-4b": (2560, 151936, 10, 1),
         "qwen2-7b": (3584, 152064, 10, 1),
         "arctic-480b": (7168, 32000, 8, 1)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True, type=Path,
                    help="the copy of the repository to time")
    ap.add_argument("--label", default="", help="tag for the output line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lm_width_times: no CUDA device")
    sys.path.insert(0, str(args.tree.resolve()))
    import chip_smoke as cs                      # puts TREE/src on the path
    from repro_torch.core.lss import LSSConfig, build_index
    from repro_torch.core.simhash import (augment_neurons, augment_queries,
                                          init_hyperplanes, unit)
    from repro_torch.kernels.lss_topk import lss_topk
    from repro_torch.kernels.lss_topk import ops as lss_topk_ops
    from repro_torch.kernels.lss_topk.ref import lss_topk_ref
    from repro_torch.kernels.lss_topk.slabs import quantize_slabs
    from repro_torch.kernels.simhash_codes import simhash_codes
    from repro_torch.kernels.simhash_codes.ref import simhash_codes_ref
    from repro_torch.testing.parity import assert_ints_equal, margin_rows

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"label": args.label, "tree": str(args.tree),
           "device": cs.nvidia_smi()}

    def timed(name, fn, plain, check):
        try:
            got = fn()
        except ValueError as e:
            out[name] = {"refused": str(e)[:120]}
            return
        check(got, plain())
        torch.cuda.synchronize()
        out[name] = {"ms": cs.time_ms(fn),
                     "plain_ms": cs.time_ms(plain, iters=5)}

    def topk_check(q, theta):
        def check(got, want):
            rows = margin_rows(q, theta)
            assert_ints_equal(got[1], want[1], rows=rows, what="top_ids")
            cs.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4,
                            rows=rows, what="top_logits")
        return check

    # the main path's shape: the narrow layout
    g = torch.Generator(dev).manual_seed(SEED)
    w_aug = augment_neurons(torch.randn(205443, 128, generator=g,
                                        device=dev) * 0.1)
    theta = init_hyperplanes(g, 129, 9, 1, device=dev)
    idx = build_index(w_aug, theta, LSSConfig(k_bits=9, n_tables=1,
                                              capacity=808))
    q = augment_queries(torch.randn(256, 128, generator=g, device=dev))
    a = (q, idx.theta, idx.tables.table_ids, idx.w_bucketed)
    timed("lss_topk main path d=129 K=9 P=808 B=256 fp32",
          lambda: lss_topk(*a, top_k=5), lambda: lss_topk_ref(*a, top_k=5),
          topk_check(q, idx.theta))
    del w_aug, idx

    for arch in LM_ARCHS:
        d_model, vocab, k_bits, n_tables = HEADS[arch]
        d = d_model + 1
        cap = LSSConfig(k_bits=k_bits, n_tables=n_tables).resolve_capacity(
            vocab)
        g = torch.Generator(dev).manual_seed(d)
        q = augment_queries(torch.randn(8, d_model, generator=g, device=dev))
        theta = torch.randn(d, k_bits * n_tables, generator=g, device=dev)
        tids = torch.randint(-1, vocab, (n_tables, 2 ** k_bits, cap),
                             generator=g, device=dev, dtype=torch.int32)
        wb = torch.randn(n_tables, 2 ** k_bits, cap, d, generator=g,
                         device=dev)
        wb[tids < 0] = 0.0
        for sdt in ("fp32", "bf16", "int8"):
            w, sc = quantize_slabs(wb, sdt)
            lay = lss_topk_ops.lss_topk_layout(d, k_bits, n_tables, cap, sdt)
            layout = "wide" if getattr(lay, "wide", False) else "narrow"
            for bsz in (8, 1):
                qb = q[:bsz].contiguous()
                a = (qb, theta, tids, w)
                timed(f"lss_topk {arch} d={d} K={k_bits} P={cap} {sdt} "
                      f"B={bsz} {layout}",
                      lambda: lss_topk(*a, top_k=1, w_scale=sc),
                      lambda: lss_topk_ref(*a, top_k=1, w_scale=sc),
                      topk_check(qb, theta))
            del w, sc
        del wb
        for bsz in (256, 4096):
            x = unit(torch.randn(bsz, d, generator=g, device=dev))

            def check(got, want, x=x):
                assert_ints_equal(got, want, rows=margin_rows(x, theta),
                                  what="codes")

            timed(f"simhash_codes {arch} d={d} K={k_bits} B={bsz}",
                  lambda: simhash_codes(x, theta, k_bits, n_tables),
                  lambda: simhash_codes_ref(x, theta, k_bits, n_tables),
                  check)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
