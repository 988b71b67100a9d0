#!/usr/bin/env python3
"""Per-stage cycle counts of the fused ``lss_topk`` CUDA kernel on one GPU.

Stamps a *copy* of the port: in ``TREE/src/repro_torch/csrc/lss_topk.cu``
it puts a ``clock64()`` stamp (thread 0 of each block, into a device
array) before each ``// ---- stage N`` header of the kernel and before the
line matching ``--end``, builds the copy with its own ``kernels/_build.py``
and runs its ``lss_topk`` op at four inputs (Delicious-200K's width, the
random model of ``chip_smoke.py``, seed 0):

* standard-normal queries, fp32 slabs, K = 9, L = 1 (C = 808), B = 1 and
  B = 256;
* standard-normal queries, fp32 slabs, K = 8, L = 4 (C = 6,432), B = 256;
* the main path's first batch: the model's embeddings of the first 256
  requests on its own index (K = 9, L = 1), as ``chip_smoke.py`` makes
  them.

For each it prints one JSON line: the cycles of each stage (stamp k+1
minus stamp k, mean/median/max over the blocks), the whole block's
cycles, and the launch's time in ms (CUDA events; the stamps included).
The stamps sit right after a ``__syncthreads()`` in the kernel, so each
marks a point the whole block has passed.

TREE must be a throw-away copy of the repository (a ``git archive``
unpacked under ``build/``): its kernel source is rewritten in place.
Run it from the repository root, on a machine with one CUDA device::

    python3 tools/lss_topk_stage_clocks.py --tree build/stages_new
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

MAX_BLOCKS, MAX_STAMPS = 4096, 8
SEED = 0

DEFS = f"""
// ---- stage clocks (inserted by tools/lss_topk_stage_clocks.py) ----
__device__ long long lss_stage_clk[{MAX_BLOCKS} * {MAX_STAMPS}];
#define LSS_STAMP(k)                                                    \\
  do {{                                                                 \\
    if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS})                  \\
      lss_stage_clk[blockIdx.x * {MAX_STAMPS} + (k)] = clock64();       \\
  }} while (0)
"""

GETTER = f"""
extern "C" int lss_stage_clocks(long long* out) {{
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, lss_stage_clk, sizeof(long long) * {MAX_BLOCKS} * {MAX_STAMPS}));
}}
"""


def stamp_source(src: str, end_pattern: str) -> tuple[str, int]:
    """Insert the stamps; returns the new source and the stage count."""
    lines = src.splitlines()
    last_include = max(i for i, l in enumerate(lines)
                       if l.startswith("#include"))
    out, n_stages, ended = [], 0, False
    for i, line in enumerate(lines):
        m = re.match(r"\s*// ---- stage (\d+)", line)
        if m:
            n_stages = max(n_stages, int(m.group(1)))
            out.append(f"  LSS_STAMP({int(m.group(1)) - 1});")
        elif re.search(end_pattern, line) and n_stages and not ended:
            out.append(f"  LSS_STAMP({n_stages});")
            ended = True
        out.append(line)
        if i == last_include:
            out.append(DEFS)
    if not n_stages or not ended:
        raise SystemExit("stage markers or the end line not found")
    return "\n".join(out) + "\n" + GETTER, n_stages


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True, type=Path,
                    help="a scratch copy of the repository (edited in place)")
    ap.add_argument("--end", default=r"// ---- end",
                    help="regex of the kernel line the last stamp precedes")
    ap.add_argument("--label", default="", help="tag for the output lines")
    args = ap.parse_args()
    tree = args.tree.resolve()
    if tree == Path(__file__).resolve().parents[1]:
        raise SystemExit("--tree must be a copy, not this repository")
    if not torch.cuda.is_available():
        raise SystemExit("lss_topk_stage_clocks: no CUDA device")
    cu = tree / "src" / "repro_torch" / "csrc" / "lss_topk.cu"
    src = cu.read_text()
    if "LSS_STAMP" not in src:
        src, _ = stamp_source(src, args.end)
        cu.write_text(src)
    n_stages = len(set(re.findall(r"LSS_STAMP\((\d+)\)", src))) - 1

    sys.path.insert(0, str(tree / "src"))
    from repro_torch.configs.paper_datasets import DELICIOUS
    from repro_torch.core.lss import LSSConfig, build_index
    from repro_torch.core.simhash import (augment_neurons, augment_queries,
                                          init_hyperplanes, unit)
    from repro_torch.data.synthetic import xc_dataset
    from repro_torch.kernels.lss_topk import lss_topk
    from repro_torch.kernels.lss_topk import ops
    from repro_torch.kernels.simhash_codes.ref import simhash_codes_ref
    from repro_torch.models.xc import XCModel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    cfg = DELICIOUS.full
    with torch.no_grad():
        # the main path's model, index and first batch, as chip_smoke.py
        gen = torch.Generator(device=dev).manual_seed(SEED)
        model = XCModel(cfg, generator=gen, device=dev)
        w_aug = augment_neurons(model.w_out, model.b_out)
        d = w_aug.shape[1]
        theta = init_hyperplanes(gen, d, DELICIOUS.lss.k_bits,
                                 DELICIOUS.lss.n_tables, device=dev)
        main_index = build_index(w_aug, theta, DELICIOUS.lss)
        data = xc_dataset(SEED, 256, cfg.input_dim, cfg.output_dim,
                          max_in=cfg.max_in, max_labels=cfg.max_labels)
        q_main = augment_queries(model.embed(
            torch.from_numpy(data.x[:256]).to(dev)))
        q_all = augment_queries(torch.randn(256, d - 1, generator=gen,
                                            device=dev))
        runs = [("normal", 9, 1, 1), ("normal", 9, 1, 256),
                ("normal", 8, 4, 256), ("main_path", 9, 1, 256)]
        for queries, k_bits, n_tables, bsz in runs:
            if queries == "main_path":
                idx, q = main_index, q_main
            else:
                theta = init_hyperplanes(gen, d, k_bits, n_tables,
                                         device=dev)
                idx = build_index(w_aug, theta, LSSConfig(
                    k_bits=k_bits, n_tables=n_tables, slab_dtype="fp32"))
                q = q_all[:bsz].contiguous()
            t = idx.tables

            def run():
                return lss_topk(q, idx.theta, t.table_ids, idx.w_bucketed,
                                top_k=5)

            run()
            flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                device=dev)
            flush.zero_()                          # a cold L2, as time_ms
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run()
            end.record()
            end.synchronize()
            clk = np.zeros(MAX_BLOCKS * MAX_STAMPS, dtype=np.int64)
            err = ops._library().lss_stage_clocks(
                clk.ctypes.data_as(ctypes.c_void_p))
            if err:
                raise SystemExit(f"cudaMemcpyFromSymbol failed: {err}")
            clk = clk.reshape(MAX_BLOCKS, MAX_STAMPS)[:bsz, :n_stages + 1]
            cyc = np.diff(clk, axis=1)
            stages = {f"stage{k + 1}": {
                "mean": float(cyc[:, k].mean()),
                "median": float(np.median(cyc[:, k])),
                "max": int(cyc[:, k].max())} for k in range(n_stages)}
            total = clk[:, -1] - clk[:, 0]
            # how many queries share each hit slab
            codes = simhash_codes_ref(unit(q), idx.theta, k_bits, n_tables)
            _, hits = np.unique(codes.cpu().numpy() + np.arange(n_tables)
                                * 2 ** k_bits, return_counts=True)
            print(json.dumps({
                "label": args.label, "queries": queries, "K": k_bits,
                "L": n_tables, "P": t.capacity, "C": t.n_tables * t.capacity,
                "B": bsz, "d": d, "mean_sample": float(out[2].float().mean()),
                "distinct_slabs": int(hits.size),
                "most_queries_on_a_slab": int(hits.max()),
                "stages": stages,
                "block_total": {"mean": float(total.mean()),
                                "median": float(np.median(total)),
                                "max": int(total.max())},
                "launch_ms": start.elapsed_time(end), "nvidia_smi": smi}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
