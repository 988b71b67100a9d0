#!/usr/bin/env python3
"""Host ms a batch of the port's main serving path, to compare copies of
the tree on one card.

The path is ``chip_smoke.py``'s ``main_path``: ``lss_predict`` (the fused
``lss_topk`` kernel) on Delicious-200K at full width, random weights from
seed 0, 256-query batches of the 2,048 requests.  Imports the port and
``chip_smoke.py``'s set-up from TREE, a copy of the repository (a ``git
archive`` unpacked under ``build/``, say), builds TREE's kernels, and times
each batch's ``lss_predict`` as ``main_path`` does, from a synchronised
start to a synchronised end on the host clock, over ``--passes`` passes of
the 8 batches where ``main_path`` makes one.  Prints one JSON line: the
median and mean ms a batch over every timed batch, each pass's mean (the
number ``main_path`` reports), and the wrappers' launches in one pass.
Where TREE's kernel registry sends only fake tensors through the
``torch.library`` ops (``registry._is_abstract``), the line also holds
``dispatch_ab``: the same passes again in this process, alternating a
pass as the tree runs with a pass whose real tensors are sent through
the dispatcher op as well, each side's median ms a batch.

Run from the repository root on a machine with one CUDA device, one
process per tree, alternating the trees::

    python3 tools/main_path_times.py --tree build/parent --label parent
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True, type=Path,
                    help="the copy of the repository to time")
    ap.add_argument("--label", default="", help="tag for the output line")
    ap.add_argument("--passes", type=int, default=50,
                    help="passes over the requests")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("main_path_times: no CUDA device")
    sys.path.insert(0, str(args.tree.resolve()))
    import chip_smoke as cs                      # puts TREE/src on the path

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    # the index and requests of chip_smoke.main, drawn in its order
    cfg = cs.DELICIOUS.full
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    model = cs.XCModel(cfg, generator=gen, device=dev)
    w_aug = cs.augment_neurons(model.w_out, model.b_out)
    theta = cs.init_hyperplanes(gen, cfg.hidden + 1, cs.DELICIOUS.lss.k_bits,
                                cs.DELICIOUS.lss.n_tables, device=dev)
    index = cs.build_index(w_aug, theta, cs.DELICIOUS.lss)
    data = cs.xc_dataset(cs.SEED, cs.N_REQUESTS, cfg.input_dim,
                         cfg.output_dim, max_in=cfg.max_in,
                         max_labels=cfg.max_labels)
    qs = [model.embed(torch.from_numpy(data.x[i:i + cs.BATCH]).to(dev))
          for i in range(0, cs.N_REQUESTS, cs.BATCH)]
    cs.lss_predict(qs[0], index, None, cs.TOP_K)        # builds, warms up
    torch.cuda.synchronize()

    def one_pass():
        ms = []
        for q in qs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cs.lss_predict(q, index, None, cs.TOP_K)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        return ms

    counters = (cs.simhash_codes_cuda, cs.lss_topk_ops.lss_topk_cuda)
    batch_ms, pass_means, launches = [], [], None
    for p in range(args.passes):
        for fn in counters:
            fn.launches = 0
        ms = one_pass()
        if launches is None:
            launches = {fn.__name__: fn.launches for fn in counters}
        batch_ms += ms
        pass_means.append(statistics.fmean(ms))
    out = {"label": args.label, "tree": str(args.tree),
           "device": cs.nvidia_smi(), "passes": args.passes,
           "batches_a_pass": len(qs),
           "batch_ms_median": statistics.median(batch_ms),
           "batch_ms_mean": statistics.fmean(batch_ms),
           "pass_mean_ms": pass_means, "launches_a_pass": launches}
    reg = cs.registry
    if hasattr(reg, "_is_abstract"):
        own, sides = reg._is_abstract, {"direct": [], "dispatcher": []}
        for p in range(2 * args.passes):
            side = ("direct", "dispatcher")[p % 2]
            reg._is_abstract = own if side == "direct" else (
                lambda a, k: True)
            try:
                sides[side] += one_pass()
            finally:
                reg._is_abstract = own
        out["dispatch_ab"] = {f"{k}_batch_ms_median": statistics.median(v)
                              for k, v in sides.items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
