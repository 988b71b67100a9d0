#!/usr/bin/env python3
"""Device times of the port's ``bucket_logits`` and ``simhash_codes``
kernels on synthetic inputs, to compare copies of the tree on one card.

Imports the port and ``chip_smoke.time_ms`` (median of 20 launches, each
after an L2 flush) from TREE, a copy of the repository (a ``git archive``
unpacked under ``build/``, say), builds TREE's kernels, holds each case
against its plain version (``--no-check`` skips that, for a variant that
leaves work out; codes are compared on the rows whose hash margin holds)
and prints one JSON line of device ms:

* ``bucket_logits``, d = 129, 256 standard-normal queries on random fp32
  slabs ``[512, 808, d]`` (Delicious-200K's P): B = 1; B = 256 on random
  slab ids (~200 distinct), fp32 and bf16 slabs; all 256 queries on one
  slab, fp32 and bf16; K = 8, L = 4: slabs ``[1024, 1608, d]``, one id a
  table;
* ``simhash_codes``, unit rows, d = 129: B = 1, 256 and 1024 at K = 9,
  L = 1, and B = 1024 at K = 8, L = 4.

Run from the repository root on a machine with one CUDA device, one
process per tree (each loads its own kernels)::

    python3 tools/kernel_times.py --tree build/variant --label variant
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

SEED = 0
D = 129


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True, type=Path,
                    help="the copy of the repository to time")
    ap.add_argument("--label", default="", help="tag for the output line")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the comparison with the plain versions")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    sys.path.insert(0, str(args.tree.resolve()))
    import chip_smoke as cs                      # puts TREE/src on the path
    from repro_torch.core.simhash import unit
    from repro_torch.kernels.bucket_logits import bucket_logits
    from repro_torch.kernels.bucket_logits.ref import bucket_logits_ref
    from repro_torch.kernels.simhash_codes import simhash_codes
    from repro_torch.kernels.simhash_codes.ref import simhash_codes_ref
    from repro_torch.testing.parity import assert_ints_equal, margin_rows

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(dev).manual_seed(SEED)
    out = {"label": args.label, "nvidia_smi": cs.nvidia_smi()}
    with torch.no_grad():
        q = torch.randn(256, D, generator=g, device=dev)
        w = torch.randn(512, 808, D, generator=g, device=dev)
        ids = torch.randint(0, 512, (256, 1), generator=g, device=dev,
                            dtype=torch.int32)
        one = torch.full((256, 1), 37, dtype=torch.int32, device=dev)
        w4 = torch.randn(1024, 1608, D, generator=g, device=dev)
        ids4 = (torch.randint(0, 256, (256, 4), generator=g, device=dev)
                + torch.arange(4, device=dev) * 256).int()
        cases = {"fp32_B1": (q[:1], w, ids[:1]), "fp32_B256": (q, w, ids),
                 "bf16_B256": (q, w.bfloat16(), ids),
                 "one_slab": (q, w, one),
                 "bf16_one_slab": (q, w.bfloat16(), one),
                 "K8L4": (q, w4, ids4)}
        for name, (a, b, c) in cases.items():
            if not args.no_check:
                err = float((bucket_logits(a, b, c)
                             - bucket_logits_ref(a, b, c)).abs().max())
                if not err <= 1e-3:
                    raise SystemExit(f"bucket_logits {name}: error {err}")
            out[name] = cs.time_ms(lambda: bucket_logits(a, b, c))
        del w, w4
        x = unit(torch.randn(1024, D, generator=g, device=dev))
        for name, bsz, k_bits, n_tables in (
                ("simhash_B1", 1, 9, 1), ("simhash_B256", 256, 9, 1),
                ("simhash_B1024", 1024, 9, 1), ("simhash_K8L4", 1024, 8, 4)):
            theta = torch.randn(D, k_bits * n_tables, generator=g,
                                device=dev)
            xs = x[:bsz].contiguous()
            if not args.no_check:                # exact on margin rows
                assert_ints_equal(
                    simhash_codes(xs, theta, k_bits, n_tables),
                    simhash_codes_ref(xs, theta, k_bits, n_tables),
                    rows=margin_rows(xs, theta), what=f"simhash {name}")
            out[name] = cs.time_ms(
                lambda: simhash_codes(xs, theta, k_bits, n_tables))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
