#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Builds the CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, then drives the
port's paths at Delicious-200K's full width (random weights from a seed):

* ``decode_attention``: the paged decode-attention kernel at the
  ``qwen2-0.5b-lss-reason`` cell's step (64 rows, 14 / 2 heads, head_dim
  64, pages of 128, max_len 5,632, one layer's arenas) against its plain
  version, timed cold beside its byte bound at the rows' lengths;
* ``prefill_attention``: the causal prefill-attention kernel at one layer
  of Qwen2-0.5B's prefill buckets (1,024, 2,048, 4,096; 14 / 2 heads of
  64) and of Qwen1.5-MoE's 512 (16 / 16 of 128) against its plain version
  (``attention_blockwise``), within an ulp of bf16, timed cold beside its
  bound at the bf16 tensor cores' peak and beside the library's
  ``scaled_dot_product_attention`` at the same shape; the decode phases
  then require one launch a layer for each prompt forward they run;
* ``main_path``: serves requests through the XC model's query embedding,
  ``lss_predict`` (the fused ``lss_topk`` kernel), ``retrieve`` (the
  ``simhash_codes`` kernel) for label recall, and the exact full head;
* ``iul``: Algorithm 1, ``fit_lss`` on the full WOL, mining through
  ``retrieve`` (``simhash_codes``), with one loss and gradient held
  against the same call on CPU copies;
* ``unfused_path``: the learned index, with fp32 and with bf16 slabs,
  served through ``retrieve`` and ``sparse_logits_bucketed`` (the
  ``bucket_logits`` kernel), held against the gather path and the fused
  ``lss_forward``;
* ``train_wol``: the paper's pipeline through
  ``repro_torch.examples.train_wol.run``: train the model 500 steps with
  the trainer (checkpoints every 100 steps to a temporary directory),
  ``fit_lss`` on its embeddings (``simhash_codes``), and serve the trained
  index (``lss_topk``) against the exact full head, with the learned
  index's recall held against a random-SimHash index's;
* ``preemption``: at ``DELICIOUS.bench`` width, a run that crashes at step
  25 and resumes from its checkpoint ends where an uninterrupted run ends;
* the paper's experiments (``repro_torch.benchmarks.paper_tables``) at the
  reference's full-pass sizes (``BENCH_FAST=0``):
  ``paper_table1_full``: Table 1's five methods (Full, LSS, SLIDE, PQ,
  ip-NSW) at Delicious-200K full width on ``train_wol``'s model and index,
  for its first 512 training rows and for the 512 rows that follow its
  training rows in the same draw (held out), with the full head's P@k
  without its bias and the share of labels whose neuron overflowed its
  bucket; ``serve_engine``: the serving stack on the same model and
  index, an ``Engine`` whose every (head, bucket) step is a captured CUDA
  graph, its results held against ``lss_forward`` and the exact full
  head, the recall auditor, and the ``AsyncRuntime`` staged and open
  loop, with the Prometheus text and a chrome trace; then
  ``serve_runtime_trace``, one second of the open loop under the port's
  deep hook (``obs.maybe_profile``): the trace file's ``lss_topk``
  kernels one a chunk, the runtime's dispatcher and completion threads
  in it;
  ``paper_table1``: Table 1 for the four settings;
  ``paper_table2``: the K x L sweep at the fast pass's sizes, each
  cell's ``lss_topk`` and ``simhash_codes`` held against their plain
  versions and timed beside their bounds; ``paper_fig2``: the per-epoch
  collision curves;
* ``decode``: streaming decode at Qwen2-0.5B's full width (24 layers,
  d_model 896, the 151,936-wide tied head; random bf16 weights):
  ``LMDecoder.fit_lss`` on the LM head (``simhash_codes``; K = 10, L = 1,
  P = 304), 16 prompts of 100-500 tokens, 128 new tokens each, through
  blocking ``generate`` (dense KV pool), the paged KV pool (prefix-shared
  prompts skip prefill) and the AsyncRuntime's decode kind, with the full
  head and the LSS head (``lss_topk``, replayed in the fused step's CUDA
  graph); every run's tokens bit for bit the blocking ones, a replay the
  eager step's, the LSS step ``lss_forward``'s, the full head within
  1e-5 of an fp32 GEMM; ms a step beside the byte bounds;
* ``refresh`` (after ``serve_engine``, on ``train_wol``'s model and
  index): ``refresh_swap``, the ``AsyncRuntime`` at 5,000 req/s while an
  ``IndexRefresher`` runs three refresh cycles (one IUL epoch on the full
  WOL -- ``simhash_codes`` --, build, warm -- ``lss_topk`` captured --,
  flip): refit, warm and flip times, latency inside swap and refit
  windows against the rest, no failed future, memory;
  ``refresh_capture``, swaps alone under the same load, in turns with
  the port's capture and ``torch.cuda.graph``'s entry; the final index
  served bit for bit as ``lss_forward`` and a cold engine serve it;
  ``refresh_rollback`` (probation reads recall 0: rolled back, the old
  index served bit for bit) and ``refresh_fail`` (an exception and a NaN
  θ in the refit: both fail, serving unchanged, the failure counter the
  injected count);
* ``refresh_decode`` (after ``decode``): a swap with 8 sessions in
  flight at Qwen2-0.5B width: the pinned sessions' tokens bit for bit
  the no-swap ones, the next generation a cold decoder's on the new
  index, its fused step built once (its capture's ms), the old epoch's
  steps freed; then the serve launcher's K = 6 index on the same head
  and ``lss_topk`` at that shape;
* ``launch``: ``repro_torch.launch.serve`` (streaming decode and async
  scoring, each with the index refreshed every second) and
  ``repro_torch.launch.train`` (twice on one directory, the second run
  resuming) as subprocesses at full width;
* vocab-sharded serving (after ``serve_engine``, on ``train_wol``'s
  trained WOL): ``sharded_index``, ``shard_index`` into 1, 2 and 4 shards
  with fp32 and int8 slabs (the last of 2 and of 4 padded by one row),
  each shard's ``lss_topk`` against its plain version, no padded id, the
  1-shard head bit for bit the ``lss`` head, the in-process oracle timed;
  ``sharded_engine``, ``Engine(head="lss-sharded")`` on a one-rank NCCL
  process group, its captured steps (the merge after the replay) bit for
  bit the ``lss`` head over 2,048 rows; ``fleet``, two processes on the
  one card over gloo as 2 hosts (this script with ``--fleet-worker``),
  each building only its shard: predict, ``rank``, the AsyncRuntime at
  1,000 req/s, a committed and an aborted ``leader_swap_index``, bit for
  bit a one-process 2-shard oracle; and (after ``launch``)
  ``fleet_launch``: the serve launcher as a two-process fleet at full
  width (``--head lss-sharded --coordinator ... --process-id i``),
  generate and async with refresh, and ``--mode decode`` refused;
* the rest of the model zoo (after the paper's experiments):
  ``moe_decode``, qwen2-moe-a2.7b at full width and depth (24 layers,
  d_model 2,048, 60 experts padded to 64, top-4, the shared expert;
  random bf16 weights): ``LMDecoder.fit_lss`` on the 151,936-wide head
  (K = 10, L = 1, P = 304), 8 prompts x 64 new tokens through blocking
  ``generate`` and interleaved on the dense pool with both heads (tokens
  bit for bit), the paged pool with shared prefixes (agreement
  reported), ms a step beside the bound; ``arctic_decode``, arctic-480b
  at full width cut to one layer (d_model 7,168, 128 experts top-2 with
  the dense residual MLP in parallel, vocab 32,000): ``fit_lss`` at
  K = 8 through the tiled ``simhash_codes``, interleaved sessions through
  the wide ``lss_topk``; ``bert4rec_serve``, BERT4Rec's full config
  (1,000,000 items) at 512 rows: encode, then the LSS top-10 through
  ``lss_topk`` over the item head (K = 12, L = 1, P = 496), held against
  the plain version, with the exact top-10's recall; ``zoo_step``:
  DeepFM, AutoInt and DIEN at full width (512 rows) and the GCN at
  full_graph_sm and molecule, a forward and a loss-and-gradient step
  each.

Each path is driven with the kernels' launch counts set to 0 just before
it and read just after (``train_wol``: after each of its stages; the
paper phases: each setting, query set or sweep); a kernel of the path
that was not launched fails the run.  Checks and timings made inside a
path's run do not count.  ``serve_engine``'s, ``sharded_engine``'s,
``fleet``'s and ``decode``'s steps are CUDA graphs, whose replays call no
wrapper: their wrappers count each step's warm-up and capture, and
``torch.profiler`` counts the kernels the replays ran (in ``fleet``, in
each process's serving window).  The launchers run in their own
processes and print their wrappers' counts, which the kernels line
reports.

Four profiler windows also print a ``breakdown`` line (the top device
ops by device time, the top host ops by self time, wall seconds and
the device-busy share): ``serve_engine``'s LSS pass, the
``serve_runtime_trace`` window, ``decode``'s paged LSS run and the
zoo's interleaved LSS decodes (``moe_decode``, ``arctic_decode``).

Every phase prints one JSON line; a failed check or an exception exits
non-zero.  The line before the last is the card's name and power limit
(``nvidia-smi``), the last is ``{"ok": true, "device": {...}}``.

Run from the repository root, on a machine with one CUDA device::

    python3 chip_smoke.py
"""

from __future__ import annotations

import ast
import contextlib
import faulthandler
import gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import weakref
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch import obs, resolve_device
    from repro_torch.benchmarks import paper_tables
    from repro_torch.configs import (arctic_480b, bert4rec, qwen2_0_5b,
                                     qwen2_moe_a2_7b)
    from repro_torch.configs.registry import get_config as get_arch
    from repro_torch.configs.paper_datasets import DELICIOUS
    from repro_torch.core.iul import (MinedPairs, fit_lss, iul_init,
                                      iul_loss_and_grad, mine_pairs)
    from repro_torch.core.lss import (LSSConfig, avg_sample_size,
                                      bucket_slab_inputs, build_index,
                                      dedup_mask, label_recall, lss_forward,
                                      lss_predict, precision_at_k, retrieve,
                                      sparse_logits_bucketed,
                                      sparse_logits_gather)
    from repro_torch.core.sharded import (local_part, make_multihost_predict,
                                          make_sharded_predict,
                                          multihost_merge, topk_merge)
    from repro_torch.core.simhash import (augment_neurons, augment_queries,
                                          init_hyperplanes, unit)
    from repro_torch.core.tables import build_tables, bucketize_weights
    from repro_torch.core.topk import NEG_INF, topk_lowest_index
    from repro_torch.data.pipeline import ShardedBatchIterator
    from repro_torch.data.synthetic import (ctr_dataset, graph_dataset,
                                            lm_dataset, seqrec_dataset,
                                            xc_dataset)
    from repro_torch.distributed import (ServingMesh, init_distributed,
                                         make_serving_mesh,
                                         make_training_mesh,
                                         shutdown_distributed)
    from repro_torch.examples import train_wol
    from repro_torch.kernels import _build, registry
    from repro_torch.kernels.bucket_logits import bucket_logits
    from repro_torch.kernels.bucket_logits.ops import (bucket_logits_cuda,
                                                       bucket_logits_plan)
    from repro_torch.kernels.bucket_logits.ref import bucket_logits_ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_cuda)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.lss_topk import lss_topk
    from repro_torch.kernels.lss_topk import ops as lss_topk_ops
    from repro_torch.kernels.lss_topk.ref import lss_topk_ref
    from repro_torch.kernels.prefill_attention import prefill_attention
    from repro_torch.kernels.prefill_attention.ops import (
        prefill_attention_cuda)
    from repro_torch.kernels.prefill_attention.ref import (
        prefill_attention_ref)
    from repro_torch.kernels.simhash_codes import simhash_codes
    from repro_torch.kernels.simhash_codes.ops import (simhash_codes_cuda,
                                                       simhash_codes_plan)
    from repro_torch.kernels.simhash_codes.ref import simhash_codes_ref
    from repro_torch.launch.roofline import peak_flops
    from repro_torch.launch.serve import LSS_CONFIG as LAUNCH_LSS
    from repro_torch.launch.steps import build_cell, ctr_logits, ctr_loss
    from repro_torch.obs import (assert_quiescent, maybe_profile,
                                 trace_export)
    from repro_torch.obs.audit import RecallAuditor
    from repro_torch.obs.export import prometheus_text
    from repro_torch.serve import AsyncRuntime, Engine, LMDecoder
    from repro_torch.serve import step as step_mod
    from repro_torch.serve.heads import (make_lss_head,
                                         make_sharded_lss_head, shard_index)
    from repro_torch.serve.multihost import (follower_loop, init_multihost,
                                             stop_followers)
    from repro_torch.serve.refresh import IndexRefresher, RefreshConfig
    from repro_torch.serve.step import release_graphs
    from repro_torch.serve.runtime import (submit_decode_open_loop,
                                           submit_open_loop)
    from repro_torch.models import gnn, recsys
    from repro_torch.models import transformer as T
    from repro_torch.models import xc
    from repro_torch.models.xc import XCModel
    from repro_torch.testing import faults
    from repro_torch.testing.parity import (assert_close, assert_ints_equal,
                                            assert_topk_ids_equal,
                                            margin_rows)
    from repro_torch.optim.compression import (compressed_psum,
                                               init_error_state,
                                               quantize_int8)
    from repro_torch.train.trainer import (TrainConfig, Trainer,
                                           make_train_step, value_and_grad)
    from repro_torch.utils.sharding import (P, full_tensor, named_sharding,
                                            stages_gathers, to_local,
                                            use_mesh)
    from repro_torch.utils.tree import (tree_flatten, tree_leaves,
                                        tree_unflatten)
    from tools.check_metrics import parse_exposition
except ImportError as e:
    sys.exit(f"chip_smoke: {e} (run it from the repository root)")

# ---- the parity contract on the card (kernel vs plain, both on the card)
MARGIN_EPS = 1e-5          # rows with min |theta^T q_hat| <= this may flip a
MAX_EXCLUDED_FRAC = 0.01   # hash bit; they are excluded (< 1% of the rows)
LOGIT_RTOL = 1e-4          # fp32 top logits: the kernel sums in another
LOGIT_ATOL = 1e-4          # order than the plain version's einsum
TIE_TOL = 1e-4             # top ids exact where neighbours differ by more
# LOGIT_ATOL and TIE_TOL are for logits of order 1.  Where the largest
# |top logit| is below 1 (the random model's main path gives ~1e-4), both
# scale down with it, so the check still bites at that scale.
# main path: LSS top logits against the full head's logits of the same ids
# (both fp32 dots of the same vectors; the random model's logits are ~1e-4)
HEAD_RTOL, HEAD_ATOL = 1e-4, 1e-8
# iul: one loss and its theta gradient on the card against the same call
# on CPU copies (the sums run in other orders on the two devices)
IUL_RTOL = IUL_ATOL = 1e-5
# preemption: the resumed run's parameters against the uninterrupted run's.
# An element whose Adam step flipped sign would be 2 lr = 1e-2 off; sums
# taken in another order over 15 steps move a parameter by ~1e-7 (the JAX
# package against the port on the CPU, tests/test_torch_train_infra.py)
PREEMPT_ATOL = 1e-5

# ---- the card's published peaks (H100 SXM data sheet) for bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12    # outside the tensor cores
PEAK_BF16_FLOPS = 989e12   # the tensor cores, dense
SPIN_CLOCK_HZ = 1.98e9     # boost clock: converts host seconds to spin cycles

SEED = 0
N_REQUESTS, BATCH, TOP_K = 2048, 256, 5
TIME_ITERS = 20
STEP_ITERS = 10            # train steps timed after train_wol's run
PAPER_SETTINGS = ("wiki10-31k", "delicious-200k", "text8", "wiki-text-2")
TABLE2_CHECKED = 64        # test queries held against the plain version
TABLE2_CHUNK = 16          # queries a plain call: [16, 50,000, 65] rows
TABLE1_CHUNK = 256         # queries a plain call: [256, <= 1,000, 97] rows
SERVE_REQUESTS = 2048      # serve_engine: training rows served
SERVE_QPS = 5000.0         # serve_engine: the open-loop Poisson rate
DECODE_STREAMS = 8         # decode: pool slots (rows of the fused step)
DECODE_MAX_LEN = 1024      # decode: pool width
DECODE_PROMPTS = 16        # decode: sessions of 100-500 prompt tokens
DECODE_NEW = 128           # decode: new tokens a session
DECODE_CALIB = (8, 513)    # decode: fit_lss rows x tokens (4,096 positions)
DECODE_IUL_EPOCHS = 4
DECODE_QPS = 20.0          # decode: the open loop's sessions a second
REFRESH_CYCLES = 3         # refresh_swap: refresh_once cycles under load
CAPTURE_SWAPS = 6          # refresh_capture: swaps, captures in turns
REFRESH_MARGIN_S = 0.05    # a request this close after a swap counts in it
LAUNCH_QPS = 4.0           # launch: decode sessions a second (the pool
                           # drains between them, so swaps reach decode)
SHARD_COUNTS = (1, 2, 4)   # sharded_index: vocab shards of the trained WOL
FLEET_QPS = 1000.0         # fleet, fleet_launch: the open loop's rate
FLEET_TIMEOUT_S = 300      # fleet: the two processes, killed after this
FLEET_LAUNCH_TIMEOUT_S = 600   # fleet_launch: one two-process launch
SHARDED_STEPS = 60         # sharded_train: (1, 2) steps against one process
SHARDED_QUERIES = 256      # sharded_train: rows each rank's shard serves
DP_STEPS = 5               # sharded_train: (2, 1) steps
# sharded_train: a loss of the (1, 2) and (2, 1) runs against the
# one-process run's (sums over the vocab shards and the batch halves run
# in other orders, and Adam carries their last bits from step to step)
SHARDED_RTOL = 1e-4
# the launchers' training before they serve or resume (launch, fleet_launch,
# sharded_train's first launcher run)
LAUNCH_TRAIN_STEPS = 20
SHARDED_LAUNCH_STEPS = 24  # sharded_train: the launcher's 2x1 run resumes
SHARDED_LAUNCH_BATCH = 8   # at LAUNCH_TRAIN_STEPS and trains to this step
# decode: the full head's top logit against an fp32 GEMM of the same
# hidden states (both fp32 GEMMs; scaled like LOGIT_ATOL)
DECODE_FULL_TOL = 1e-5
MOE_PROMPTS = 8            # moe_decode: prompts 4-11 of decode_prompts
MOE_NEW = 64               # moe_decode: new tokens a session
ARCTIC_LAYERS = 1          # arctic_decode: 35 layers do not fit one card
ARCTIC_PROMPTS = 4         # arctic_decode: sessions
ARCTIC_NEW = 16            # arctic_decode: new tokens a session
ZOO_BATCH = 512            # serve_p99's batch (bert4rec_serve, zoo_step)
# cells: build_cell's cells run on the card and dry-run at the same cut
CELLS = (("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "decode_32k"),
         ("bert4rec", "serve_p99"), ("deepfm", "serve_p99"),
         ("gcn-cora", "molecule"))
CELL_TRAIN_BATCH = 8       # cells: train_4k's global_batch, halved to fit
CELL_DRYRUN_TIMEOUT_S = 600
BERT4REC_TOP_K = 10


class SmokeFailure(AssertionError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters: int = TIME_ITERS) -> float:
    """Median device time of ``fn`` in ms over ``iters`` launches, each
    with a cold L2 (a 256 MB buffer is written before each launch).

    Before each launch the card spins for twice as long as one call of
    ``fn`` takes on the host, so ``fn``'s work is queued before the start
    event fires: the events bracket device time, not host time."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()                                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin_cycles = int(2 * (time.perf_counter() - t0) * SPIN_CLOCK_HZ)
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------- checks --

def compare_simhash(x, theta, k_bits, n_tables):
    """Kernel vs plain on the same unit rows: exact on margin rows."""
    got = simhash_codes(x, theta, k_bits, n_tables)          # the kernel
    want = simhash_codes_ref(x, theta, k_bits, n_tables)
    torch.cuda.synchronize()
    rows = margin_rows(x, theta, MARGIN_EPS)
    assert_ints_equal(got, want, rows=rows, what="simhash_codes")
    diff = (got.long() - want.long()).abs().cpu().numpy()[rows]
    return rows, int(diff.max(initial=0))


def logit_scale(want) -> float:
    """min(1, the largest |logit| of ``want``): the factor for LOGIT_ATOL
    and TIE_TOL (masked NEG_INF slots aside)."""
    real = want[want > NEG_INF / 2]
    return min(1.0, float(real.abs().max())) if real.numel() else 1.0


def compare_lss_topk(q_aug, theta, table_ids, w_bucketed, w_scale, top_k,
                     chunk=None):
    """Kernel vs plain of the same storage, per the parity contract; the
    plain version runs ``chunk`` queries at a time (it gathers ``[B, C, d]``
    rows).  Returns the margin rows, the checks' numbers and the kernel's
    output."""
    got = lss_topk(q_aug, theta, table_ids, w_bucketed, top_k=top_k,
                   w_scale=w_scale)                          # the kernel
    chunk = chunk or q_aug.shape[0]
    parts = [lss_topk_ref(q_aug[i:i + chunk], theta, table_ids, w_bucketed,
                          top_k=top_k + 1, w_scale=w_scale)
             for i in range(0, q_aug.shape[0], chunk)]
    ext = tuple(torch.cat(p) for p in zip(*parts))
    torch.cuda.synchronize()
    rows = margin_rows(q_aug, theta, MARGIN_EPS)
    assert_ints_equal(got[3], ext[3], rows=rows, what="cand")
    assert_ints_equal(got[2], ext[2], rows=rows, what="sample")
    want = ext[0][:, :top_k]
    scale = logit_scale(want)
    atol, tie = LOGIT_ATOL * scale, TIE_TOL * scale
    err = assert_close(got[0], want, rtol=LOGIT_RTOL, atol=atol, rows=rows,
                       what="top_logits")
    n_ids = assert_topk_ids_equal(got[1], ext[1][:, :top_k], want, tie,
                                  rows=rows, next_logit=ext[0][:, top_k],
                                  what="top_ids")
    return rows, {"max_abs_err": err, "atol": atol, "tie_tol": tie,
                  "ids_checked": n_ids, "ids": int(got[1].numel())}, got


def compare_bucket_logits(q, w_flat, slab_ids):
    """Kernel vs plain on the same inputs: allclose, per the contract."""
    got = bucket_logits(q, w_flat, slab_ids)                # the kernel
    want = bucket_logits_ref(q, w_flat, slab_ids)
    torch.cuda.synchronize()
    atol = LOGIT_ATOL * logit_scale(want)
    err = assert_close(got, want, rtol=LOGIT_RTOL, atol=atol,
                       what="bucket_logits")
    return {"max_abs_err": err, "atol": atol}


# ------------------------------------------------------------- bounds --

def bound(nbytes, flops, flops_peak=PEAK_FP32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / flops_peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def simhash_bound_ms(bsz, d, k_bits, n_tables):
    kl = k_bits * n_tables
    return bound(4 * (bsz * d + d * kl + bsz * n_tables), 2 * bsz * d * kl)


def lss_topk_bound_ms(q_aug, index, cand, top_k):
    """Bytes this batch's data needs: each distinct hit slab once (its P
    ids, and the rows of its occupied slots, + a fp32 scale each for
    int8), the queries, theta and the outputs; flops: 2*d per occupied
    slot per query, fp32."""
    t = index.tables
    bsz, d = q_aug.shape
    row = d * index.w_bucketed.element_size() + (
        4 if index.w_scale is not None else 0)
    buckets = simhash_codes_ref(unit(q_aug), index.theta, t.k_bits,
                                t.n_tables)
    slab_ids = buckets.long() + torch.arange(
        t.n_tables, device=buckets.device) * t.n_buckets
    uniq, first = np.unique(slab_ids.cpu().numpy().reshape(-1),
                            return_index=True)
    # occupied slots of each distinct slab, read off the first query that
    # hit it
    occ = (cand.reshape(bsz, t.n_tables, t.capacity) >= 0).sum(-1)
    occ_uniq = int(occ.reshape(-1).cpu().numpy()[first].sum())
    nbytes = (len(uniq) * t.capacity * 4 + occ_uniq * row + 4 * bsz * d
              + 4 * index.theta.numel() + 4 * cand.numel() + 8 * bsz * top_k
              + 4 * bsz)
    return bound(nbytes, 2 * d * int((cand >= 0).sum()))


def bucket_logits_bound_ms(q, w_flat, slab_ids):
    """Bytes: each distinct hit slab once (every slot row: the op takes no
    ids), the queries, the slab ids and the logits; flops 2*B*L*P*d."""
    bsz, d = q.shape
    cap = w_flat.shape[1]
    n_tables = slab_ids.shape[1]
    n_distinct = int(torch.unique(slab_ids).numel())
    nbytes = (n_distinct * cap * d * w_flat.element_size()
              + bsz * d * q.element_size() + 4 * bsz * n_tables
              + 4 * bsz * n_tables * cap)
    return bound(nbytes, 2 * bsz * n_tables * cap * d) + (n_distinct,)


def slab_inputs(q_aug, index):
    """What ``sparse_logits_bucketed`` hands ``bucket_logits`` for
    ``q_aug`` (``bucket_slab_inputs``), with the buckets hashed by the
    plain version, so no kernel count moves."""
    t = index.tables
    buckets = simhash_codes_ref(unit(q_aug), index.theta, t.k_bits,
                                t.n_tables)
    return bucket_slab_inputs(index, buckets)


# ------------------------------------------------------------- phases --

def phase_device():
    dev = resolve_device(None)
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})
    require(not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32, "TF32 must be off")
    return dev, smi


def phase_build():
    t0 = time.perf_counter()
    per = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_seconds": per, "flags": " ".join(_build.NVCC_FLAGS)})


def phase_launch_floor(dev):
    """What ``time_ms`` reads for one launch that does next to nothing (a
    one-element add): no kernel timed this way can take less."""
    tiny = torch.zeros(1, device=dev)
    emit({"phase": "launch_floor", "ms": time_ms(lambda: tiny.add_(1))})


def phase_simhash(dev, gen, q_main):
    d = q_main.shape[1]
    n_rows = n_excl = 0
    cases = [("random", 1024, 9, 1), ("random", 1024, 8, 4),
             ("main_path", q_main.shape[0], 9, 1), ("main_path", 1, 9, 1)]
    thetas = {}
    for src, bsz, k_bits, n_tables in cases:
        # B = 1 reuses the main path's theta: no draw, so every later input
        # is the one earlier trees of this script made
        key = (src, k_bits, n_tables)
        if key not in thetas:
            thetas[key] = init_hyperplanes(gen, d, k_bits, n_tables,
                                           device=dev)
        theta = thetas[key]
        x = unit(torch.randn(bsz, d, generator=gen, device=dev)
                 if src == "random" else q_main[:bsz])
        plan = simhash_codes_plan(bsz, d, k_bits, n_tables,
                                  _build.sm_count(x.device))
        launches = simhash_codes_cuda.launches
        rows, err = compare_simhash(x, theta, k_bits, n_tables)
        ms = time_ms(lambda: simhash_codes(x, theta, k_bits, n_tables))
        plain = time_ms(lambda: simhash_codes_ref(x, theta, k_bits, n_tables))
        b_ms, b_by, nbytes, flops = simhash_bound_ms(bsz, d, k_bits, n_tables)
        emit({"phase": "simhash_codes", "inputs": src, "B": bsz, "d": d,
              "K": k_bits, "L": n_tables, "rows_per_block": plan.rows,
              "grid": plan.blocks, "smem_bytes": plan.smem,
              "excluded_rows": int((~rows).sum()),
              "max_abs_err": err, "ms": ms, "plain_ms": plain,
              "launches": simhash_codes_cuda.launches - launches,
              "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
              "flops": flops})
        n_rows += bsz
        n_excl += int((~rows).sum())
    require(n_excl < MAX_EXCLUDED_FRAC * n_rows,
            f"simhash_codes: {n_excl} of {n_rows} rows lack the margin")


def phase_lss_topk(dev, gen, w_aug, setting):
    """The kernel against its plain version at the main path's shape (K, L
    and capacity of the setting) in fp32, bf16 and int8, B = 1 and 256;
    at K = 8, L = 4 (C = 6,432); and at K = 8, L = 4 with capacity 4,096
    (C = 16,384, the largest C the JAX package serves: its per-slot arrays
    go to the scratch tensor), B = 64."""
    d = w_aug.shape[1]
    cases = [(setting.lss.k_bits, setting.lss.n_tables, 0, s, b)
             for s in ("fp32", "bf16", "int8") for b in (1, 256)]
    cases += [(8, 4, 0, "fp32", 256), (8, 4, 4096, "fp32", 64)]
    # standard-normal queries: logits of order 1, so the 1e-4 tolerances
    # of the contract bite (the random model's embeddings give ~1e-4)
    q_aug = augment_queries(torch.randn(256, d - 1, generator=gen,
                                        device=dev))
    indexes, n_rows, n_excl = {}, 0, 0
    for k_bits, n_tables, capacity, sdt, bsz in cases:
        key = (k_bits, n_tables, capacity, sdt)
        if key not in indexes:
            theta = init_hyperplanes(gen, d, k_bits, n_tables, device=dev)
            indexes[key] = build_index(w_aug, theta, LSSConfig(
                k_bits=k_bits, n_tables=n_tables, capacity=capacity,
                slab_dtype=sdt))
        idx = indexes[key]
        t = idx.tables
        shape = (d, t.k_bits, t.n_tables, t.capacity)
        lay = lss_topk_ops.lss_topk_layout(*shape, sdt)
        lib = lss_topk_ops._library()
        storage = lss_topk_ops._STORAGE[sdt]
        require(lay.smem == lib.lss_topk_smem_bytes(*shape, storage)
                and lay.scratch == lib.lss_topk_scratch_bytes(*shape, storage),
                "smem or scratch formula drifted")
        q = q_aug[:bsz].contiguous()
        args = (q, idx.theta, t.table_ids, idx.w_bucketed)
        launches = lss_topk_ops.lss_topk_cuda.launches
        rows, check, got = compare_lss_topk(*args, idx.w_scale, TOP_K)
        ms = time_ms(lambda: lss_topk(*args, top_k=TOP_K,
                                      w_scale=idx.w_scale))
        plain = time_ms(lambda: lss_topk_ref(*args, top_k=TOP_K,
                                             w_scale=idx.w_scale), iters=5)
        b_ms, b_by, nbytes, flops = lss_topk_bound_ms(q, idx, got[3], TOP_K)
        emit({"phase": "lss_topk", "slab_dtype": sdt, "B": bsz, "d": d,
              "K": t.k_bits, "L": t.n_tables, "P": t.capacity,
              "C": t.n_tables * t.capacity, "smem_bytes": lay.smem,
              "scratch_bytes": bsz * lay.scratch,
              "blocks_per_sm": lss_topk_ops.lss_topk_blocks_per_sm(*shape,
                                                                   sdt),
              "rows_per_chunk": lay.rows,
              "excluded_rows": int((~rows).sum()), **check,
              "mean_sample": float(got[2].float().mean()), "ms": ms,
              "plain_ms": plain,
              "launches": lss_topk_ops.lss_topk_cuda.launches - launches,
              "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
              "flops": flops})
        n_rows += bsz
        n_excl += int((~rows).sum())
    require(n_excl < MAX_EXCLUDED_FRAC * n_rows,
            f"lss_topk: {n_excl} of {n_rows} rows lack the margin")


def phase_bucket_logits(dev, gen, w_aug, setting):
    """The kernel against its plain version at the main path's shape (K, L
    of the setting: one slab of P rows per query) in fp32 and bf16, B = 1
    and 256; at the multi-table shape K = 8, L = 4; and with all 256
    queries on one slab (the first query's), where one slab is read for
    every query.  Each case prints its launch plan."""
    d = w_aug.shape[1]
    k9, l1 = setting.lss.k_bits, setting.lss.n_tables
    cases = [(k9, l1, sdt, b, False) for sdt in ("fp32", "bf16")
             for b in (1, 256)]
    cases += [(8, 4, "fp32", 256, False), (k9, l1, "fp32", 256, True)]
    # standard-normal queries: logits of order 1, so the tolerances bite
    q_aug = augment_queries(torch.randn(256, d - 1, generator=gen,
                                        device=dev))
    indexes = {}
    for k_bits, n_tables, sdt, bsz, one_slab in cases:
        key = (k_bits, n_tables, sdt, bsz)
        if not one_slab:         # one slab: the hashed case's index again
            theta = init_hyperplanes(gen, d, k_bits, n_tables, device=dev)
            indexes[key] = build_index(w_aug, theta, LSSConfig(
                k_bits=k_bits, n_tables=n_tables, slab_dtype=sdt))
        idx = indexes[key]
        q = q_aug[:bsz].to(idx.w_bucketed.dtype).contiguous()
        w_flat, slab_ids = slab_inputs(q_aug[:bsz], idx)
        if one_slab:
            slab_ids = slab_ids[:1].expand_as(slab_ids).contiguous()
        plan = bucket_logits_plan(bsz, n_tables, w_flat.shape[1], d,
                                  w_flat.dtype, _build.sm_count(q.device))
        launches = bucket_logits_cuda.launches
        check = compare_bucket_logits(q, w_flat, slab_ids)
        ms = time_ms(lambda: bucket_logits(q, w_flat, slab_ids))
        plain = time_ms(lambda: bucket_logits_ref(q, w_flat, slab_ids),
                        iters=5)
        b_ms, b_by, nbytes, flops, n_distinct = bucket_logits_bound_ms(
            q, w_flat, slab_ids)
        t = idx.tables
        emit({"phase": "bucket_logits", "dtype": sdt, "B": bsz, "d": d,
              "K": t.k_bits, "L": t.n_tables, "P": t.capacity,
              "slab_ids": "one slab" if one_slab else "hashed",
              "distinct_slabs": n_distinct, "rows_per_block": plan.block_rows,
              "rows_per_chunk": plan.rows, "grid": plan.blocks,
              "threads": 32 * plan.warps, "query_tile": plan.group,
              "smem_bytes": plan.smem, **check,
              "ms": ms, "plain_ms": plain,
              "launches": bucket_logits_cuda.launches - launches,
              "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
              "flops": flops})


ATTN_SHAPE = dict(b=64, n=14, kv=2, h=64, page=128, max_len=5632)


def attention_inputs(dev, lengths, b, n, kv, h, page, max_len, seed=0):
    """One layer of a paged pool in bf16: each row's pages shuffled
    through the arena up to its write page (a parked row, length 0, maps
    only scratch page 0), the step's q and new rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    n_pp = -(-max_len // page)
    table = 1 + rng.permutation(b * n_pp).reshape(b, n_pp)
    for i, m in enumerate(lengths):
        table[i, min(int(m), max_len - 1) // page + 1:] = 0
    table[np.asarray(lengths) == 0] = 0

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    return dict(q=rand(b, n, h), k_arena=rand(1 + b * n_pp, page, kv, h),
                v_arena=rand(1 + b * n_pp, page, kv, h),
                page_table=torch.from_numpy(table.astype(np.int32)).to(dev),
                lengths=torch.tensor(np.asarray(lengths, np.int32),
                                     device=dev),
                k_new=rand(b, kv, h), v_new=rand(b, kv, h), max_len=max_len)


def attention_bound_ms(lengths, n, kv, h, max_len, isz=2):
    """K and V of each row's context read once (its new row, read from
    the step's k, v and written to its page, counts as the read); q.k and
    p.v, 4 * N * H fp32 operations a position."""
    positions = int(np.minimum(np.asarray(lengths) + 1, max_len).sum())
    return bound(2 * positions * kv * h * isz, 4 * positions * n * h)


def attention_error(got, want):
    """The largest error of an output against the plain version's, as a
    share of 2^-7 (an ulp of bf16) times that element's magnitude plus
    its own (row, head)'s largest output: at most 1 where every row is
    within its own scale."""
    g, w = got.float(), want.float()
    limit = 2 ** -7 * (w.abs() + w.abs().amax(-1, keepdim=True))
    return float(((g - w).abs() / limit).max())


def phase_decode_attention(dev):
    """The kernel against its plain version at the reason cell's step,
    for lengths drawn from 1..max_len with two full and two parked rows,
    with every row long and ending inside a split, and with every row
    full; each output within an ulp of bf16 of its own (row, head)'s
    scale.  Device ms (cold L2) beside the byte bound at those lengths
    and the plain version's ms."""
    sh = ATTN_SHAPE
    rng = np.random.default_rng(SEED)
    drawn = rng.integers(1, sh["max_len"], sh["b"])
    drawn[:2], drawn[2:4] = sh["max_len"], 0
    # every row long; none of their last splits (256 positions) full
    long = rng.integers(sh["max_len"] - 1000, sh["max_len"] - 1, sh["b"])
    long[(long + 1) % 256 == 0] -= 1
    entry = None
    for case, lengths in (("drawn", drawn), ("long", long),
                          ("full", np.full(sh["b"], sh["max_len"]))):
        args = attention_inputs(dev, lengths, **sh)
        plain_args = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                      for k, v in args.items()}
        launches = decode_attention_cuda.launches
        got = decode_attention(**args)
        want = decode_attention_ref(**plain_args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        rel = attention_error(got, want)
        arenas_equal = all(torch.equal(args[s][1:], plain_args[s][1:])
                           for s in ("k_arena", "v_arena"))
        require(rel <= 1.0, f"decode_attention ({case}): an output is off "
                f"by {rel} of its limit against the plain version")
        require(arenas_equal, f"decode_attention ({case}): the arenas "
                f"differ from the plain version's")
        require(decode_attention_cuda.launches == launches + 1,
                "decode_attention: the wrapper did not launch once")
        ms = time_ms(lambda: decode_attention(**args))
        plain = time_ms(lambda: decode_attention_ref(**plain_args), iters=5)
        b_ms, b_by, nbytes, flops = attention_bound_ms(
            lengths, sh["n"], sh["kv"], sh["h"], sh["max_len"])
        emit({"phase": "decode_attention", "case": case, **sh,
              "positions": int(np.minimum(lengths + 1, sh["max_len"]).sum()),
              "max_abs_err": err, "out_scale": scale,
              "err_of_row_limit": rel,
              "arenas_equal": arenas_equal, "ms": ms, "plain_ms": plain,
              "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
              "flops": flops, "roofline_pct": 100.0 * b_ms / ms})
        if entry is None:
            entry = {"name": "decode_attention", "route": "cuda",
                     "source": "src/repro_torch/csrc/decode_attention.cu",
                     "replaces": None, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None}
    return entry


# prefill_attention: (model, query heads, KV heads, head_dim, prompt
# widths) at the buckets the chat and MoE reason cells prefill, with the
# models' chunks for the plain version
PREFILL_SHAPES = (("qwen2-0.5b", 14, 2, 64, (1024, 2048, 4096)),
                  ("qwen2-moe-a2.7b", 16, 16, 128, (512,)))
PREFILL_CHUNKS = (512, 2048)


def prefill_attention_bound_ms(s, n, kv, h, isz=2):
    """q.k and p.v over the S(S+1)/2 causal pairs, 4 * N * H operations
    a pair at the bf16 tensor cores' peak; q, k and v read, the output
    written."""
    return bound((2 * s * n + 2 * s * kv) * h * isz, 4 * n * h * s * (s + 1) / 2,
                 PEAK_BF16_FLOPS)


def bf16_ulps(got, want, mag):
    """The largest error of a bf16 output against the plain version's, in
    ulps of bf16 at the plain value, less what two fp32 computations of it
    may differ by: 2^-19 of ``mag`` = sum_j p_j |v_j| (the size of the
    terms a cancelling output sums)."""
    g, w = got.float(), want.float()
    ulp = 2.0 ** (torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -120))) - 7)
    beyond = ((g - w).abs() - 2.0 ** -19 * mag.float()).clamp(min=0)
    return float((beyond / ulp).max())


def prefill_library(q, k, v, want, mag):
    """The library's causal attention at the same shape, for the kernel
    table (the port never calls it): ``scaled_dot_product_attention`` on
    float32 copies of q, k, v by the memory-efficient backend (p in
    float32, the plain version's precision) and on the bf16 operands by
    the flash backend (p rounded to bf16).  The KV heads are repeated to
    the query heads first, outside the time.  Returns each backend's
    device ms (cold L2) and its error against the plain version in the
    units of :func:`bf16_ulps`."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    r = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.repeat_interleave(r, dim=2).transpose(1, 2).contiguous()
              for t in (k, v))
    ms, ulps = {}, {}
    for name, backend, dtype in (
            ("fp32_efficient", SDPBackend.EFFICIENT_ATTENTION,
             torch.float32),
            ("bf16_flash", SDPBackend.FLASH_ATTENTION, torch.bfloat16)):
        a, b, c = (t.to(dtype) for t in (qt, kt, vt))

        def run():
            return torch.nn.functional.scaled_dot_product_attention(
                a, b, c, is_causal=True)

        with sdpa_kernel(backend):
            got = run().transpose(1, 2).to(q.dtype)
            ms[name] = time_ms(run)
        ulps[name] = bf16_ulps(got, want, mag)
    return ms, ulps


def phase_prefill_attention(dev):
    """The kernel against its plain version (``attention_blockwise`` at the
    models' chunks) at one layer of Qwen2-0.5B's prefill buckets and of
    Qwen1.5-MoE's 512: every output within an ulp of bf16, the same bits
    again.  Device ms (cold L2) beside the bound (operations, bf16 peak),
    the plain version's ms and the library's (:func:`prefill_library`);
    the entry is Qwen2-0.5B's 4,096."""
    entry = None
    for model, n, kv, h, widths in PREFILL_SHAPES:
        for s in widths:
            gen = torch.Generator(device=dev).manual_seed(SEED + s)
            q, k, v = (torch.randn((1, s, heads, h), generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for heads in (n, kv, kv))
            launches = prefill_attention_cuda.launches
            got = prefill_attention(q, k, v, *PREFILL_CHUNKS)
            want = prefill_attention_ref(q, k, v, *PREFILL_CHUNKS)
            mag = prefill_attention_ref(q, k, v.abs(), *PREFILL_CHUNKS)
            again = prefill_attention(q, k, v, *PREFILL_CHUNKS)
            torch.cuda.synchronize()
            ulps = bf16_ulps(got, want, mag)
            err = float((got.float() - want.float()).abs().max())
            require(ulps <= 1.0, f"prefill_attention ({model}, S {s}): an "
                    f"output is {ulps} ulps of bf16 off the plain version")
            require(torch.equal(again, got), f"prefill_attention ({model}, "
                    f"S {s}): a second launch gave other bits")
            require(prefill_attention_cuda.launches == launches + 2,
                    "prefill_attention: the wrapper did not launch once a "
                    "call")
            ms = time_ms(lambda: prefill_attention(q, k, v, *PREFILL_CHUNKS))
            plain = time_ms(lambda: prefill_attention_ref(
                q, k, v, *PREFILL_CHUNKS), iters=5)
            library_ms, library_ulps = prefill_library(q, k, v, want, mag)
            b_ms, b_by, nbytes, flops = prefill_attention_bound_ms(s, n, kv,
                                                                   h)
            emit({"phase": "prefill_attention", "model": model, "s": s,
                  "n": n, "kv": kv, "h": h, "max_abs_err": err,
                  "max_err_bf16_ulps": ulps, "ms": ms, "plain_ms": plain,
                  "library_ms": library_ms,
                  "library_err_bf16_ulps": library_ulps,
                  "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                  "flops": flops, "roofline_pct": 100.0 * b_ms / ms})
            if model == "qwen2-0.5b" and s == 4096:
                entry = {"name": "prefill_attention", "route": "cuda",
                         "source": "src/repro_torch/csrc/prefill_attention.cu",
                         "replaces": None, "shape": {"n": n, "kv": kv, "h": h,
                                                     "s": s},
                         "max_abs_err": err, "ms": ms, "plain_ms": plain,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": library_ms["fp32_efficient"],
                         "library": "scaled_dot_product_attention, "
                                    "float32, memory-efficient backend"}
    return entry


def phase_main_path(dev, model, index, data, counters):
    """Serve N_REQUESTS in batches through lss_predict and the full head;
    the kernels' launch counts are set to 0 just before and read after."""
    w, b = model.w_out, model.b_out
    m = w.shape[0]

    def full_head(q):
        return topk_lowest_index(q @ w.T + b, TOP_K)

    batches = [(torch.from_numpy(data.x[i:i + BATCH]).to(dev),
                torch.from_numpy(data.labels[i:i + BATCH]).to(dev))
               for i in range(0, N_REQUESTS, BATCH)]
    q0 = model.embed(batches[0][0])
    lss_predict(q0, index, None, TOP_K)                     # warm-up
    full_head(q0)
    torch.cuda.synchronize()
    registry.reset_dispatch_log()
    for fn in counters:
        fn.launches = 0
    lss_ids, full_ids, cands, labels, t_lss, t_full = [], [], [], [], 0., 0.
    for x, lab in batches:
        q = model.embed(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        top_logits, top_ids = lss_predict(q, index, None, TOP_K)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        f_logits, f_ids = full_head(q)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        t_lss += t1 - t0
        t_full += t2 - t1
        cand, _ = retrieve(augment_queries(q), index)
        # outputs are right: shapes, ids in range, finite, and each LSS
        # logit is the full head's logit of the same id (the bias is 0)
        require(top_ids.shape == (x.shape[0], TOP_K)
                and top_ids.dtype == torch.int32, "lss_predict shape")
        require(bool(((top_ids >= -1) & (top_ids < m)).all()), "id range")
        valid = top_ids >= 0
        require(bool(torch.isfinite(top_logits[valid]).all())
                and bool(torch.isfinite(f_logits).all()), "finite logits")
        exact = (q[:, None, :] * w[top_ids.clamp(min=0).long()]).sum(-1)
        assert_close(top_logits[valid], exact[valid], rtol=HEAD_RTOL,
                     atol=HEAD_ATOL, what="lss vs full-head logits")
        lss_ids.append(top_ids)
        full_ids.append(f_ids)
        cands.append(cand)
        labels.append(lab)
    launches = {fn.__name__: fn.launches for fn in counters}
    counts = {f"{k[0]}:{k[1]}": v
              for k, v in registry.dispatch_counts().items()}
    lss_ids, full_ids = torch.cat(lss_ids), torch.cat(full_ids)
    cands, labels = torch.cat(cands), torch.cat(labels)
    # retrieve (simhash_codes) and the fused pass (lss_topk) hash alike
    fwd = lss_forward(q0, index, None, TOP_K)
    rows = margin_rows(augment_queries(q0), index.theta, MARGIN_EPS)
    assert_ints_equal(fwd.cand_ids, cands[:BATCH], rows=rows,
                      what="retrieve vs lss_forward candidates")
    n_batches = len(batches)
    res = {
        "phase": "main_path", "model": DELICIOUS.name,
        "requests": N_REQUESTS, "batch": BATCH, "top_k": TOP_K,
        "lss": {"P@1": float(precision_at_k(lss_ids, labels, 1)),
                "P@5": float(precision_at_k(lss_ids, labels, 5)),
                "ms_per_batch": t_lss / n_batches * 1e3,
                "label_recall": float(label_recall(cands, labels)),
                "avg_sample_size": float(avg_sample_size(cands))},
        "full": {"P@1": float(precision_at_k(full_ids, labels, 1)),
                 "P@5": float(precision_at_k(full_ids, labels, 5)),
                 "ms_per_batch": t_full / n_batches * 1e3},
        "top1_agreement": float((lss_ids[:, 0] == full_ids[:, 0])
                                .float().mean()),
        "launches": launches, "dispatch_counts": counts,
    }
    emit(res)
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the main path")
    return launches, q0


def phase_iul(dev, model, setting, counters):
    """Algorithm 1 at full width: ``fit_lss`` with ``setting.lss`` on the
    model's WOL, on the embeddings of a separate draw of requests (seed
    SEED + 1) and their labels.  First, on the first BATCH of those
    queries mined against the starting index (the θ fit_lss starts from),
    one loss and its θ gradient on the card against CPU copies."""
    cfg, lss = setting.full, setting.lss
    data = xc_dataset(SEED + 1, N_REQUESTS, cfg.input_dim, cfg.output_dim,
                      max_in=cfg.max_in, max_labels=cfg.max_labels)
    q = torch.cat([model.embed(torch.from_numpy(data.x[i:i + BATCH]).to(dev))
                   for i in range(0, N_REQUESTS, BATCH)])
    labels = torch.from_numpy(data.labels).to(dev)
    w_aug = augment_neurons(model.w_out, model.b_out)
    q_aug = augment_queries(q)

    state = iul_init(torch.Generator(dev).manual_seed(SEED + 2), q_aug,
                     labels, w_aug, lss)
    index0 = build_index(w_aug, state.theta, lss)
    pairs = mine_pairs(q_aug[:BATCH], labels[:BATCH], w_aug, index0,
                       state.t1, state.t2)
    loss, grad = iul_loss_and_grad(state.theta, q_aug[:BATCH], w_aug, pairs)
    c_loss, c_grad = iul_loss_and_grad(
        state.theta.cpu(), q_aug[:BATCH].cpu(), w_aug.cpu(),
        MinedPairs(*(p.cpu() for p in pairs)))
    loss_err = assert_close(loss, c_loss, rtol=IUL_RTOL, atol=IUL_ATOL,
                            what="iul_loss card vs cpu")
    grad_err = assert_close(grad, c_grad, rtol=IUL_RTOL, atol=IUL_ATOL,
                            what="iul grad card vs cpu")
    start_recall = float(label_recall(retrieve(q_aug[:1024], index0)[0],
                                      labels[:1024]))
    emit({"phase": "iul_grad_check", "queries": BATCH,
          "pos_pairs": int(pairs.pos_mask.sum()),
          "neg_pairs": int(pairs.neg_mask.sum()), "t1": float(state.t1),
          "t2": float(state.t2), "loss": float(loss),
          "loss_abs_err": loss_err, "grad_max_abs_err": grad_err,
          "grad_max_abs": float(grad.abs().max()),
          "start_recall": start_recall})

    torch.cuda.synchronize()
    registry.reset_dispatch_log()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    index, hist = fit_lss(torch.Generator(dev).manual_seed(SEED + 2), q,
                          labels, model.w_out, model.b_out, lss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    counts = {f"{k[0]}:{k[1]}": v
              for k, v in registry.dispatch_counts().items()}
    for ep in range(len(hist["loss"])):
        emit({"phase": "iul_epoch", "epoch": ep,
              **{k: v[ep] for k, v in hist.items()}})
    require(len(hist["loss"]) == lss.iul_epochs, "iul: history length")
    require(all(np.isfinite(hist["loss"])), "iul: a loss is not finite")
    t = index.tables
    own = build_tables(w_aug, index.theta, t.k_bits, t.n_tables, t.capacity)
    require(torch.equal(own.table_ids, t.table_ids)
            and torch.equal(own.n_dropped, t.n_dropped),
            "iul: the fitted tables are not those of its theta")
    require(torch.equal(bucketize_weights(w_aug, own), index.w_bucketed),
            "iul: the fitted slabs are not those of its tables")
    emit({"phase": "iul", "model": setting.name, "queries": N_REQUESTS,
          "m": w_aug.shape[0], "d": w_aug.shape[1], "K": t.k_bits,
          "L": t.n_tables, "P": t.capacity, "epochs": lss.iul_epochs,
          "batch": lss.iul_batch, "inner_steps": lss.iul_inner_steps,
          "lr": lss.iul_lr, "seconds": seconds,
          "best_recall": max(hist["recall"]),
          "launches": launches, "dispatch_counts": counts})
    require(launches["simhash_codes_cuda"] > 0,
            "simhash_codes was not launched on the iul path")
    return index


def phase_unfused_path(dev, model, index, data, counters):
    """Serve N_REQUESTS on the learned index through retrieve ->
    sparse_logits_bucketed (bucket_logits), against the gather path on the
    same candidates, then through lss_forward; and through a bf16 copy of
    the index's slabs, against the gather path on the same bf16 rows.  The
    kernels' launch counts are set to 0 just before and read after."""
    w_aug = augment_neurons(model.w_out, model.b_out)
    w_aug16 = w_aug.bfloat16()
    index16 = index._replace(w_bucketed=index.w_bucketed.bfloat16())
    batches = [torch.from_numpy(data.x[i:i + BATCH]).to(dev)
               for i in range(0, N_REQUESTS, BATCH)]
    torch.cuda.synchronize()
    registry.reset_dispatch_log()
    for fn in counters:
        fn.launches = 0
    t_unfused, t_bf16, errs, errs16 = 0., 0., [], []
    top_errs, n_checked, n_excl = [], 0, 0
    for x in batches:
        q = model.embed(x)
        q_aug = augment_queries(q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cand, buckets = retrieve(q_aug, index)
        lb, ids = sparse_logits_bucketed(q_aug, index, buckets)
        torch.cuda.synchronize()
        t_unfused += time.perf_counter() - t0
        lg = sparse_logits_gather(q_aug, w_aug, cand)
        assert_ints_equal(ids, cand, what="unfused ids vs retrieve")
        valid = cand >= 0
        require(bool(torch.isfinite(lb[valid]).all()), "finite logits")
        atol = LOGIT_ATOL * logit_scale(lg)
        errs.append(assert_close(lb[valid], lg[valid], rtol=LOGIT_RTOL,
                                 atol=atol, what="bucketed vs gather"))
        # the fused pass on the same index: each top logit is the unfused
        # logit of the same id (rows where the hash margin holds)
        fwd = lss_forward(q, index, None, TOP_K)
        rows = torch.from_numpy(margin_rows(q_aug, index.theta, MARGIN_EPS)
                                ).to(dev)
        n_excl += int((~rows).sum())
        hit = ids[:, None, :] == fwd.top_ids[:, :, None]    # [B, k, C]
        top_ok = (fwd.top_ids >= 0) & rows[:, None]
        require(bool(hit.any(-1)[top_ok].all()),
                "a top id of lss_forward is not among the candidates")
        unfused_top = lb.gather(-1, hit.int().argmax(-1))
        top_errs.append(assert_close(
            fwd.top_logits[top_ok], unfused_top[top_ok], rtol=LOGIT_RTOL,
            atol=atol, what="lss_forward vs unfused logits"))
        n_checked += int(top_ok.sum())
        # bf16 slabs go to the kernel as stored; the gather path widens the
        # same bf16 rows, so the two agree as in fp32
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, buckets16 = retrieve(q_aug, index16)
        lb16, ids16 = sparse_logits_bucketed(q_aug, index16, buckets16)
        torch.cuda.synchronize()
        t_bf16 += time.perf_counter() - t0
        assert_ints_equal(ids16, cand, what="bf16 unfused ids vs retrieve")
        lg16 = sparse_logits_gather(q_aug, w_aug16, cand)
        errs16.append(assert_close(lb16[valid], lg16[valid], rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL * logit_scale(lg16),
                                   what="bf16 bucketed vs gather"))
    launches = {fn.__name__: fn.launches for fn in counters}
    counts = {f"{k[0]}:{k[1]}": v
              for k, v in registry.dispatch_counts().items()}
    emit({"phase": "unfused_path", "requests": N_REQUESTS, "batch": BATCH,
          "ms_per_batch": t_unfused / len(batches) * 1e3,
          "bf16_ms_per_batch": t_bf16 / len(batches) * 1e3,
          "max_abs_err_vs_gather": max(errs),
          "bf16_max_abs_err_vs_gather": max(errs16),
          "max_abs_err_fused_vs_unfused": max(top_errs),
          "top_logits_checked": n_checked, "excluded_rows": n_excl,
          "launches": launches, "dispatch_counts": counts})
    require(n_excl < MAX_EXCLUDED_FRAC * N_REQUESTS,
            f"unfused_path: {n_excl} of {N_REQUESTS} rows lack the margin")
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the unfused path")
    return launches, augment_queries(model.embed(batches[0]))


def phase_train_wol(dev, counters):
    """The paper's pipeline at Delicious-200K width through the example's
    ``run``: train 500 steps (checkpoints in a temporary directory, removed
    afterwards), ``fit_lss``, serve the first 512 training rows.  The
    kernels' launch counts are set to 0 before the run and read and reset
    after each stage.  Then, on the trained model: ms per train step, both
    heads' ms per 256-query batch, the LSS logits against the WOL's, the
    trained index's first batch through ``compare_lss_topk``, and the
    learned index's recall against a random-SimHash index's."""
    marks = []
    base_mem = torch.cuda.memory_allocated()

    def on_stage(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter(),
                      {fn.__name__: fn.launches for fn in counters},
                      (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 20))
        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="train_wol_") as ckpt_dir:
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        res = train_wol.run(ckpt_dir=ckpt_dir, device=dev, on_stage=on_stage)
    seconds, launches, peak_mb, prev = {}, {}, {}, t0
    for name, t, counts, peak in marks:
        seconds[name], launches[name], peak_mb[name], prev = \
            t - prev, counts, peak, t
    cfg, lss, tr = res["config"], res["lss_config"], res["trainer"]
    hist, iul_hist = res["history"], res["iul_history"]

    for h in hist:
        emit({"phase": "train_wol_step", **h})
    losses = [h["loss"] for h in hist]
    require(all(np.isfinite(losses)), "train_wol: a loss is not finite")
    require(len(hist) > 1 and losses[-1] < losses[0],
            f"train_wol: the loss did not fall ({losses[0]} -> {losses[-1]})")
    require(hist[-1]["step"] == res["steps"] == 500, "train_wol: steps")

    # ms per step: host clock around synchronised steps of the trainer's
    # step on the trained state (results dropped: a step that does not
    # donate, so the trained state stays as it is)
    data = res["data"]
    batch = next(ShardedBatchIterator({"x": data.x, "labels": data.labels},
                                      BATCH, device=dev))
    step_fn = make_train_step(tr.loss_fn, tr.tc)
    step_ms = []
    for _ in range(STEP_ITERS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step_fn(res["state"], batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    n_params = sum(t.numel() for t in tree_leaves(res["state"].params))
    require(n_params == cfg.param_count() == DELICIOUS.full.param_count(),
            "train_wol: not the full-width model")
    # a step holds the old state, the gradients (twice: before and after
    # clipping), the new state and the activations, under 4x the state;
    # a state kept alive from step to step grows past it in a few steps
    state_mb = sum(t.numel() * t.element_size()
                   for t in tree_leaves(res["state"])) / 2 ** 20
    emit({"phase": "train_wol_train", "model": cfg.name,
          "input_dim": cfg.input_dim, "hidden": cfg.hidden,
          "output_dim": cfg.output_dim, "params": n_params,
          "steps": res["steps"], "batch": BATCH,
          "train_rows": int(data.x.shape[0]), "seconds": seconds["train"],
          "ms_per_step_median": float(np.median(step_ms)),
          "ms_per_step": step_ms, "saves": len(tr.save_seconds),
          "save_seconds": tr.save_seconds,
          "seconds_less_saves": seconds["train"] - sum(tr.save_seconds),
          "state_mb": state_mb, "peak_device_memory_mb": peak_mb,
          "launches": launches["train"]})
    require(peak_mb["train"] < 4 * state_mb,
            f"train_wol: {peak_mb['train']:.0f} MB at the peak of training")

    for ep in range(len(iul_hist["loss"])):
        emit({"phase": "train_wol_iul_epoch", "epoch": ep,
              **{k: v[ep] for k, v in iul_hist.items()}})
    index = res["index"]
    t = index.tables
    emit({"phase": "train_wol_fit_lss", "seconds": seconds["fit_lss"],
          "queries": int(data.x.shape[0]) - res["n_test"], "K": t.k_bits,
          "L": t.n_tables, "P": t.capacity, "epochs": lss.iul_epochs,
          "inner_steps": lss.iul_inner_steps, "lr": lss.iul_lr,
          "best_recall": max(iul_hist["recall"]),
          "launches": launches["fit_lss"]})
    require(launches["fit_lss"]["simhash_codes_cuda"] > 0,
            "simhash_codes was not launched by fit_lss")
    require(launches["serve"]["lss_topk_cuda"] > 0,
            "lss_topk was not launched while serving the trained index")

    model = res["model"]
    w, b = model.w_out.float(), model.b_out.float()
    n_test = res["n_test"]
    q_te = model.embed(torch.from_numpy(data.x[:n_test]).to(dev))
    lab_te = torch.from_numpy(data.labels[:n_test]).to(dev)

    def full_head(q):
        return topk_lowest_index(q @ w.T + b, TOP_K)

    def lss_head(q):
        return lss_predict(q, index, None, TOP_K)

    heads = {"full": full_head, "lss": lss_head}
    out, ms = {}, {}
    for name, fn in heads.items():
        out[name] = [fn(q_te[i:i + BATCH]) for i in range(0, n_test, BATCH)]
        elapsed = []
        for _ in range(5):
            for i in range(0, n_test, BATCH):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fn(q_te[i:i + BATCH])
                torch.cuda.synchronize()
                elapsed.append(time.perf_counter() - t1)
        ms[name] = float(np.median(elapsed)) * 1e3
    lss_logits = torch.cat([o[0] for o in out["lss"]])
    lss_ids = torch.cat([o[1] for o in out["lss"]])
    full_ids = torch.cat([o[1] for o in out["full"]])
    # each LSS top logit is the WOL's logit of the same id: LSS scores
    # [q, 0]·[w, b], the full head's logit less its bias
    valid = lss_ids >= 0
    require(bool(torch.isfinite(lss_logits[valid]).all()), "finite logits")
    exact = (q_te[:, None, :] * w[lss_ids.clamp(min=0).long()]).sum(-1)
    head_err = assert_close(lss_logits[valid], exact[valid], rtol=HEAD_RTOL,
                            atol=HEAD_ATOL, what="trained lss vs WOL logits")

    # the kernel against its plain version on the trained, skewed index
    q_aug = augment_queries(q_te[:BATCH])
    rows, check, _ = compare_lss_topk(q_aug, index.theta, t.table_ids,
                                      index.w_bucketed, index.w_scale, TOP_K)
    emit({"phase": "train_wol_kernel_check",
          "excluded_rows": int((~rows).sum()), **check})
    require((~rows).sum() < MAX_EXCLUDED_FRAC * BATCH,
            "train_wol: rows lack the hash margin")

    # the JAX package's claim: the learned index retrieves labels at least
    # as well as a random-SimHash index of the same shape
    w_aug = augment_neurons(w, b)
    theta0 = init_hyperplanes(torch.Generator(dev).manual_seed(9),
                              w_aug.shape[1], t.k_bits, t.n_tables,
                              device=dev)
    idx0 = build_index(w_aug, theta0, lss)
    q_aug_te = augment_queries(q_te)
    cand, _ = retrieve(q_aug_te, index)
    rec_learned = float(label_recall(cand, lab_te))
    rec_random = float(label_recall(retrieve(q_aug_te, idx0)[0], lab_te))
    emit({"phase": "train_wol_serve", "rows": n_test, "batch": BATCH,
          "eval_rows": "the first 512 training rows", "top_k": TOP_K,
          "full": {**res["full"], "ms_per_batch": ms["full"]},
          "lss": {**res["lss"], "n_dropped": res["n_dropped"],
                  "ms_per_batch": ms["lss"]},
          "top1_agreement": float((lss_ids[:, 0] == full_ids[:, 0])
                                  .float().mean()),
          "random_simhash_recall": rec_random,
          "random_simhash_n_dropped": int(idx0.tables.n_dropped.sum()),
          "lss_vs_wol_logit_max_abs_err": head_err,
          "seconds": seconds["serve"], "launches": launches["serve"]})
    require(rec_learned == res["lss"]["label_recall"],
            "train_wol: recall differs from the run's")
    require(rec_learned >= rec_random,
            f"learned recall {rec_learned} below random {rec_random}")
    return res


def phase_preemption(dev):
    """At ``DELICIOUS.bench`` width (the example's ``--fast`` data): 40
    steps uninterrupted, against a run that crashes at step 25 (checkpoints
    every 10) and resumes from step 20 in a new trainer."""
    cfg = DELICIOUS.bench
    data = xc_dataset(11, 2048, cfg.input_dim, cfg.output_dim, n_topics=128,
                      max_in=cfg.max_in, max_labels=cfg.max_labels)
    arrays = {"x": data.x, "labels": data.labels}
    tc = TrainConfig(lr=5e-3, warmup_steps=5, total_steps=40,
                     weight_decay=0.0, ckpt_every=10, keep_last=2)

    def fit(ckpt_dir, crash_after=None):
        tr = Trainer(lambda p, b: xc.loss(p, b, cfg),
                     lambda g: xc.init_params(g, cfg, dev), tc,
                     ckpt_dir=ckpt_dir, device=dev)
        it = ShardedBatchIterator(arrays, BATCH, seed=7, device=dev)
        return tr.fit(torch.Generator(dev).manual_seed(0), it, 40,
                      crash_after=crash_after, log_every=10 ** 9)[0]

    with tempfile.TemporaryDirectory(prefix="preempt_") as root:
        ref = fit(f"{root}/a")
        try:
            fit(f"{root}/b", crash_after=25)
        except RuntimeError as e:
            require("simulated preemption" in str(e), f"preemption: {e}")
        else:
            raise SmokeFailure("preemption: the run did not crash")
        got = fit(f"{root}/b")
    errs = {k: float((got.params[k] - ref.params[k]).abs().max())
            for k in ref.params}
    emit({"phase": "preemption", "model": cfg.name, "steps": 40,
          "crash_after": 25, "resumed_from": 20, "max_abs_err": errs,
          "bitwise_equal": all(torch.equal(got.params[k], ref.params[k])
                               for k in ref.params), "atol": PREEMPT_ATOL})
    require(int(got.step) == 40, "preemption: the resumed run's step")
    require(max(errs.values()) <= PREEMPT_ATOL,
            f"preemption: resumed parameters differ by {max(errs.values())}")


# ------------------------------------------------- the paper's experiments --

@contextlib.contextmanager
def uncounted(counters):
    """Kernel launches inside do not count: a check or a timing made in the
    middle of a path's run leaves the path's counts as they were."""
    saved = [fn.launches for fn in counters]
    try:
        yield
    finally:
        for fn, n in zip(counters, saved):
            fn.launches = n


def reset(counters):
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0


def read(counters):
    torch.cuda.synchronize()
    return {fn.__name__: fn.launches for fn in counters}


def count_prefill_forwards():
    """Wrap ``transformer.prefill`` (every prompt's forward, on whichever
    path) in a counter with the kernel wrappers' ``launches``, so that a
    path's prefills are counted apart from the kernel's launches; returns
    the counter, which ``reset`` / ``read`` / ``uncounted`` take."""
    inner = T.prefill

    def prefill_forwards(*args, **kwargs):
        prefill_forwards.launches += 1
        return inner(*args, **kwargs)

    prefill_forwards.launches = 0
    T.prefill = prefill_forwards
    return prefill_forwards


def check_prefills(launches, n_layers, what):
    """Each prompt forward of a path's counted run launched the
    prefill-attention kernel once a layer; returns the path's counts."""
    n, got = launches["prefill_forwards"], launches["prefill_attention_cuda"]
    require(n > 0 and got == n_layers * n,
            f"{what}: prefill_attention wrapper launches {got}, not one a "
            f"layer ({n_layers}) in each of {n} prompt forwards")
    return {"forwards": n, "launches": got}


def check_rows(rows, m, what):
    """Table 1's five rows: the methods in order, finite metrics in range,
    the full head's recall 1 over all m neurons, LSS and SLIDE below m."""
    require([r.method for r in rows] == ["Full", "LSS", "SLIDE", "PQ",
                                         "ip-NSW"], f"{what}: methods")
    for r in rows:
        vals = (r.p1, r.p5, r.recall, r.sample, r.us_per_query,
                r.mflop_per_query)
        require(all(np.isfinite(vals)), f"{what} {r.method}: not finite")
        require(0 <= r.p1 <= 1 and 0 <= r.p5 <= 1 and 0 <= r.recall <= 1,
                f"{what} {r.method}: a rate outside [0, 1]")
        require(r.us_per_query > 0 and r.mflop_per_query > 0,
                f"{what} {r.method}: time or work not positive")
    require(rows[0].recall == 1.0 and rows[0].sample == m,
            f"{what}: the full head")
    require(0 < rows[1].sample < m and 0 < rows[2].sample < m,
            f"{what}: LSS or SLIDE scored no neuron or all")


def row_dicts(rows, smi):
    return [{**r._asdict(), "device": smi} for r in rows]


def hold_index(index, q_aug, what, checked, chunk):
    """Outside the counts: ``lss_topk`` on ``index`` against its plain
    version on the first ``checked`` rows of ``q_aug`` with the hash margin
    (the plain version ``chunk`` queries a call), and ``simhash_codes`` at
    the index's K*L against its plain version on every row.  At least 90%
    of the rows must have the margin."""
    t = index.tables
    margin = margin_rows(q_aug, index.theta, MARGIN_EPS)
    require(margin.mean() >= 0.9,
            f"{what}: {int((~margin).sum())} rows lack the hash margin")
    q_chk = q_aug[torch.from_numpy(np.flatnonzero(margin)[:checked])
                  .to(q_aug.device)].contiguous()
    _, check, _ = compare_lss_topk(q_chk, index.theta, t.table_ids,
                                   index.w_bucketed, index.w_scale, TOP_K,
                                   chunk=chunk)
    s_rows, s_err = compare_simhash(unit(q_aug), index.theta, t.k_bits,
                                    t.n_tables)
    return ({"checked_queries": q_chk.shape[0],
             "rows_without_margin": int((~margin).sum()), **check},
            {"excluded_rows": int((~s_rows).sum()), "max_abs_err": s_err})


def phase_paper_table1(dev, smi, counters):
    """Table 1 (``run_setting``) for the paper's four settings at the
    reference's full-pass sizes: train, fit_lss, then Full, LSS, SLIDE, PQ
    and ip-NSW on the test queries.  The kernels' counts are set to 0
    before each setting and read after it.  Each setting's fitted index
    then holds ``lss_topk`` and ``simhash_codes`` against their plain
    versions on all its test queries, outside the counts: the LSTM
    setting's d = 97 and each setting's P are shapes no other phase
    checks."""
    rows, seconds, train_seconds, launches, checks = [], {}, {}, {}, {}

    def on_setting(got, index, q_te, train_s):
        name = got[0].dataset
        train_seconds[name] = train_s
        t = index.tables
        with uncounted(counters):
            lss_check, s_check = hold_index(
                index, augment_queries(q_te).contiguous(),
                f"paper_table1 {name}", q_te.shape[0], TABLE1_CHUNK)
        checks[name] = {"d": index.theta.shape[0], "K": t.k_bits,
                        "L": t.n_tables, "P": t.capacity,
                        "C": t.n_tables * t.capacity, "B": q_te.shape[0],
                        "lss_topk": lss_check, "simhash_codes": s_check}

    for name in PAPER_SETTINGS:
        setting = paper_tables.SETTINGS[name]
        reset(counters)
        t0 = time.perf_counter()
        got = paper_tables.run_setting(name, device=dev,
                                       on_setting=on_setting)
        launches[name] = read(counters)
        seconds[name] = time.perf_counter() - t0
        m = (setting.bench.vocab if setting.kind == "lstm"
             else setting.bench.output_dim)
        check_rows(got, m, f"paper_table1 {name}")
        require(name in checks, f"paper_table1 {name}: index not checked")
        rows += row_dicts(got, smi)
        for kernel in ("simhash_codes_cuda", "lss_topk_cuda"):
            require(launches[name][kernel] > 0,
                    f"{kernel} was not launched by Table 1's {name}")
    emit({"phase": "paper_table1", "fast": paper_tables.FAST, "rows": rows,
          "seconds": seconds, "train_seconds": train_seconds,
          "launches": launches, "kernel_checks": checks})


def phase_paper_table2(dev, smi, counters):
    """Table 2 (``table2_kl_sweep``) at the reference's fast pass
    (``paper_tables.FAST``: K in {4, 6} x L in {1, 10}, 2,048 rows, 150
    training steps, 4 IUL epochs a cell) on the Delicious stand-in; the
    full pass's 9 cells (K up to 8, L up to 50) took 175-186 s of the
    script's 1,200 s limit.  At each cell, outside the counts: the fitted
    index's ``lss_topk`` against its plain version on the first
    TABLE2_CHECKED test queries with the hash margin (the plain version in
    chunks of TABLE2_CHUNK), the layout the kernel takes, its device ms on
    all test queries beside its bound, and ``simhash_codes`` at K*L against
    its plain version."""
    cells = []
    t_prev = [time.perf_counter()]

    def on_cell(row, index, q_te):
        fit_s = time.perf_counter() - t_prev[0]
        with uncounted(counters):
            cells.append(table2_cell(row, index, q_te, fit_s, smi))
        t_prev[0] = time.perf_counter()

    reset(counters)
    t0 = time.perf_counter()
    paper_tables.FAST = True
    try:
        rows = paper_tables.table2_kl_sweep(device=dev, on_cell=on_cell)
    finally:
        paper_tables.FAST = False
    launches = read(counters)
    seconds = time.perf_counter() - t0
    for cell in cells:
        emit(cell)
    shapes = {(c["K"], c["L"]) for c in cells}
    require(len(rows) == len(cells) == 4
            and shapes == {(k, l) for k in (4, 6) for l in (1, 10)},
            "paper_table2: not the fast pass's 4 cells")
    for r in rows:
        require(0 <= r["P@1"] <= 1 and 0 <= r["P@5"] <= 1
                and r["sample"] > 0, f"paper_table2 {r}: out of range")
    emit({"phase": "paper_table2", "fast": True, "rows": rows,
          "seconds": seconds, "launches": launches, "device": smi})
    for kernel in ("simhash_codes_cuda", "lss_topk_cuda"):
        require(launches[kernel] > 0, f"{kernel} was not launched by "
                "Table 2")


def table2_cell(row, index, q_te, fit_s, smi):
    t = index.tables
    d = index.theta.shape[0]
    shape = (d, t.k_bits, t.n_tables, t.capacity)
    lay = lss_topk_ops.lss_topk_layout(*shape)
    lib = lss_topk_ops._library()
    require(lay.smem == lib.lss_topk_smem_bytes(*shape, 0)
            and lay.scratch == lib.lss_topk_scratch_bytes(*shape, 0),
            "smem or scratch formula drifted")
    require(lay.smem <= _build.SMEM_LIMIT_BYTES, "paper_table2: smem")
    q_aug = augment_queries(q_te).contiguous()
    check, s_check = hold_index(index, q_aug, f"paper_table2 K={t.k_bits} "
                                f"L={t.n_tables}", TABLE2_CHECKED,
                                TABLE2_CHUNK)
    args = (q_aug, index.theta, t.table_ids, index.w_bucketed)
    got = lss_topk(*args, top_k=TOP_K)
    ms = time_ms(lambda: lss_topk(*args, top_k=TOP_K))
    b_ms, b_by, nbytes, flops = lss_topk_bound_ms(q_aug, index, got[3],
                                                  TOP_K)
    code_args = (unit(q_aug), index.theta, t.k_bits, t.n_tables)
    s_ms = time_ms(lambda: simhash_codes(*code_args))
    s_b, s_by, _, _ = simhash_bound_ms(*q_aug.shape, t.k_bits, t.n_tables)
    plan = simhash_codes_plan(*q_aug.shape, t.k_bits, t.n_tables,
                              _build.sm_count(q_aug.device))
    return {"phase": "paper_table2_cell", **row, "P": t.capacity,
            "C": t.n_tables * t.capacity, "B": q_aug.shape[0], "d": d,
            "fit_and_eval_seconds": fit_s,
            "lss_topk": {"smem_bytes": lay.smem,
                         "scratch_bytes_per_query": lay.scratch,
                         "scratch_bytes": q_aug.shape[0] * lay.scratch,
                         "blocks_per_sm":
                             lss_topk_ops.lss_topk_blocks_per_sm(*shape),
                         **check, "ms": ms, "bound_ms": b_ms,
                         "bound_by": b_by, "bytes": nbytes, "flops": flops},
            "simhash_codes": {"K*L": t.k_bits * t.n_tables,
                              "stride": plan.stride, "smem_bytes": plan.smem,
                              **s_check, "ms": s_ms,
                              "bound_ms": s_b, "bound_by": s_by},
            "device": smi}


def phase_paper_fig2(dev, counters):
    """Fig. 2 (``fig2_collision_curves``): per-epoch IUL loss, P+ and P-
    collision rates and recall on the Delicious stand-in."""
    reset(counters)
    t0 = time.perf_counter()
    hist = paper_tables.fig2_collision_curves(device=dev)
    launches = read(counters)
    epochs = paper_tables.SETTINGS["delicious-200k"].bench_lss.iul_epochs
    emit({"phase": "paper_fig2", "fast": paper_tables.FAST, **hist,
          "seconds": time.perf_counter() - t0, "launches": launches})
    require(all(len(v) == epochs and np.isfinite(v).all()
                for v in map(np.asarray, hist.values())),
            "paper_fig2: curves")
    require(launches["simhash_codes_cuda"] > 0,
            "simhash_codes was not launched by Fig. 2")


def phase_paper_table1_full(dev, smi, res, counters):
    """Table 1's five methods at Delicious-200K full width, on the model
    and index ``train_wol`` trained and fitted (nothing is trained again),
    for two query sets: the first 512 training rows (as the reference
    measures) and the 512 rows that follow the training rows in the same
    ``xc_dataset`` draw (held out).  Then the full head's P@k without its
    bias, and the share of each set's labels whose neuron overflowed its
    bucket in the trained index: the two causes of LSS's gap."""
    cfg, lss, data, n_test = (res["config"], res["lss_config"], res["data"],
                              res["n_test"])
    model, index = res["model"], res["index"]
    w, b = model.w_out.float(), model.b_out.float()
    n_train = data.x.shape[0]
    more = xc_dataset(11, n_train + n_test, cfg.input_dim, cfg.output_dim,
                      n_topics=128, max_in=cfg.max_in,
                      max_labels=cfg.max_labels)
    require(np.array_equal(more.x[:n_train], data.x)
            and np.array_equal(more.labels[:n_train], data.labels),
            "paper_table1_full: the longer draw does not extend train_wol's")

    def embed(x):
        return torch.cat([model.embed(torch.from_numpy(x[i:i + BATCH])
                                      .to(dev))
                          for i in range(0, x.shape[0], BATCH)])

    def labels(y):
        return torch.from_numpy(y).to(dev)

    sets = {"training_rows": (embed(data.x[:n_test]),
                              labels(data.labels[:n_test]),
                              f"rows 0-{n_test - 1} (trained on)"),
            "held_out": (embed(more.x[n_train:]),
                         labels(more.labels[n_train:]),
                         f"rows {n_train}-{n_train + n_test - 1} "
                         "(never trained on)")}
    t = index.tables
    in_index = torch.zeros(w.shape[0], dtype=torch.bool, device=dev)
    in_index[t.table_ids[t.table_ids >= 0].long()] = True
    out, nobias, overflow = {}, {}, {}
    for name, (q, lab, rows_desc) in sets.items():
        reset(counters)
        t0 = time.perf_counter()
        rows, _, _ = paper_tables.eval_methods(DELICIOUS.name, lss, w, b, q,
                                               lab, index=index)
        launches = read(counters)
        seconds = time.perf_counter() - t0
        check_rows(rows, w.shape[0], f"paper_table1_full {name}")
        for kernel in ("simhash_codes_cuda", "lss_topk_cuda"):
            require(launches[kernel] > 0, f"{kernel} was not launched by "
                    f"paper_table1_full {name}")
        batches = q.shape[0] / BATCH
        out[name] = {"queries": rows_desc, "rows": row_dicts(rows, smi),
                     "seconds": seconds, "launches": launches,
                     "launches_per_256_queries":
                         {k: v / batches for k, v in launches.items()}}
        ids = topk_lowest_index(q @ w.T, TOP_K)[1]
        nobias[name] = {"P@1": float(precision_at_k(ids, lab, 1)),
                        "P@5": float(precision_at_k(ids, lab, 5)),
                        "with_bias_P@1": rows[0].p1}
        valid = lab >= 0
        dropped = valid & ~in_index[lab.clamp(min=0).long()]
        overflow[name] = {"labels": int(valid.sum()),
                          "overflowed": int(dropped.sum()),
                          "share": float(dropped.sum() / valid.sum()),
                          "lss_label_recall": rows[1].recall}
        with uncounted(counters):
            q_aug = augment_queries(q[:BATCH])
            margin, check, _ = compare_lss_topk(
                q_aug, index.theta, t.table_ids, index.w_bucketed,
                index.w_scale, TOP_K)
            out[name]["lss_topk_check"] = {
                "excluded_rows": int((~margin).sum()), **check}
            require((~margin).sum() < MAX_EXCLUDED_FRAC * BATCH,
                    "paper_table1_full: rows lack the hash margin")
    emit({"phase": "paper_table1_full", "model": cfg.name,
          "input_dim": cfg.input_dim, "hidden": cfg.hidden,
          "output_dim": cfg.output_dim, "K": t.k_bits, "L": t.n_tables,
          "P": t.capacity, "n_dropped": int(t.n_dropped.sum()),
          "fast": paper_tables.FAST, **out, "device": smi})
    emit({"phase": "paper_table1_full_nobias",
          "what": "full head P@k of q @ w.T (no bias)", **nobias})
    emit({"phase": "paper_table1_full_overflow",
          "what": "labels whose neuron overflowed its bucket", **overflow})


# ----------------------------------------------------- the serving engine --

def serve_pattern(eng, x, labels, seed, max_group=48, head=None):
    """Submit the rows in ragged groups of 1 to ``max_group - 1``
    (``np.random.default_rng(seed)``, as the JAX serving example draws
    them), flushing after each group.  Returns the results in submit order
    and the group sizes."""
    rng = np.random.default_rng(seed)
    res, sizes, i = [], [], 0
    while i < x.shape[0]:
        n = min(int(rng.integers(1, max_group)), x.shape[0] - i)
        for j in range(i, i + n):
            eng.submit({"x": x[j]}, labels=labels[j])
        res += eng.flush(head)
        sizes.append(n)
        i += n
    return res, sizes


def stack_results(res):
    return (np.stack([r.logits for r in res]),
            np.stack([r.ids for r in res]))


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def same_tensor_bits(a, b) -> bool:
    """The same dtype, shape and bytes (any dtype, bf16 included)."""
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def device_kernel_count(prof, name: str) -> int:
    """The device kernels in a profiler window whose name holds ``name``
    (kernels inside a CUDA graph's replay are listed one by one), read
    from the profiler's raw records: ``prof.events()`` would first build
    an event object for each of a decode run's ~500,000 kernels."""
    from torch.autograd import DeviceType
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and name in e.name())


BREAKDOWN_TOP = 8


def window_breakdown(prof, window: str, smi: str, trace=None) -> dict:
    """Where a profiler window's time went, from the raw kineto records
    (as ``device_kernel_count`` reads them): the top device ops
    (kernels, copies, sets) by summed device time, with count, ms and
    share of all device time, and ``lss_topk``'s; the top host ops by
    self time (an op's time less that of the ops it encloses on its
    thread); the window's
    wall seconds (first record to last); the device-busy share (the
    union of the device ops' intervals over that wall); and, where the
    window was written to ``trace`` (``maybe_profile``'s profiler), the
    file's size and export seconds.  Prints the line and returns it."""
    from torch.autograd import DeviceType
    t_start = time.perf_counter()
    dev_ns, dev_n, spans, host = {}, {}, [], {}
    lo, hi = float("inf"), float("-inf")
    for e in prof.profiler.kineto_results.events():
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue                       # ranges mirrored from the host
            name = e.name()
            dev_ns[name] = dev_ns.get(name, 0) + t1 - t0
            dev_n[name] = dev_n.get(name, 0) + 1
            spans.append((t0, t1))
        else:
            host.setdefault(e.start_thread_id(), []).append(
                (t0, t1, e.name()))
        lo, hi = min(lo, t0), max(hi, t1)
    busy, end = 0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    self_ns, self_n = {}, {}
    for ops in host.values():
        stack = []                            # [end, name, self ns]
        for t0, t1, name in sorted(ops, key=lambda o: (o[0], -o[1])):
            while stack and stack[-1][0] <= t0:
                _, n, s = stack.pop()
                self_ns[n] = self_ns.get(n, 0) + s
            if stack:
                stack[-1][2] -= min(t1, stack[-1][0]) - t0
            stack.append([t1, name, t1 - t0])
            self_n[name] = self_n.get(name, 0) + 1
        for _, n, s in stack:
            self_ns[n] = self_ns.get(n, 0) + s
    total = sum(dev_ns.values())
    wall = (hi - lo) / 1e9 if spans or host else 0.0
    top_dev = sorted(dev_ns, key=dev_ns.get, reverse=True)[:BREAKDOWN_TOP]
    top_host = sorted(self_ns, key=self_ns.get, reverse=True)[:BREAKDOWN_TOP]
    ours = [n for n in dev_ns if "lss_topk" in n]
    ours_ns = sum(dev_ns[n] for n in ours)
    line = {"phase": "breakdown", "window": window, "window_s": wall,
            "device_ops": len(spans), "device_ms": total / 1e6,
            "device_busy_ms": busy / 1e6,
            "device_busy_share": busy / 1e9 / wall if wall else 0.0,
            "device_top": [{"name": n[:120], "count": dev_n[n],
                            "ms": dev_ns[n] / 1e6,
                            "share": dev_ns[n] / total}
                           for n in top_dev],
            "lss_topk": {"count": sum(dev_n[n] for n in ours),
                         "ms": ours_ns / 1e6,
                         "share": ours_ns / total if total else 0.0},
            "host_threads": len(host),
            "host_top": [{"name": n[:120], "count": self_n[n],
                          "self_ms": self_ns[n] / 1e6} for n in top_host],
            "trace_bytes": None, "export_s": None}
    if trace is not None:
        line.update(trace_bytes=os.path.getsize(trace.trace_path),
                    export_s=trace.export_s)
    line.update(seconds=time.perf_counter() - t_start, device=smi)
    emit(line)
    return line


def host_ms(fn, iters: int = TIME_ITERS) -> float:
    """Median host-clock ms of ``fn`` from a synchronised start to a
    synchronised end."""
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def runtime_run(eng, x, labels, qps, start=True):
    """``x``'s rows through a fresh AsyncRuntime: paced at ``qps`` (0: a
    burst), or staged before the workers start (``start=False``).
    Returns the results and the runtime's stats."""
    rt = AsyncRuntime(eng, max_queue=4 * x.shape[0], policy="block",
                      start=start)
    reqs = [{"x": row} for row in x]
    futs, _ = submit_open_loop(rt, reqs, qps, seed=0, labels=labels)
    rt.start()
    rt.drain(timeout=600.0)
    res = [f.result(timeout=60.0) for f in futs]
    stats = rt.stats()
    rt.close(timeout=60.0)
    return res, stats


def phase_serve_engine(dev, smi, model, index, lss_cfg, data, counters):
    """The serving stack on the trained model and index: an ``Engine``
    with the default buckets and the recall auditor at rate 1.0, every
    (head, bucket) step captured as a CUDA graph first.  Then
    ``SERVE_REQUESTS`` training rows through ``submit``/``flush`` in
    ragged groups (LSS head; the counted run is the builds and this pass,
    which runs under ``torch.profiler``: one ``lss_topk`` kernel on the
    device a group; each result bit for bit a direct ``lss_forward``; the
    metrics' integer counts those of the same rows' candidates), the same
    groups through the full head (against ``topk_lowest_index(q @ w.T +
    b)`` per the parity contract), the auditor's recall against the full
    head's, a second arrival pattern (no new build), host ms per group at
    each bucket (graph replay against the eager head), the async runtime
    staged and open loop, and the Prometheus text and trace.  Returns the
    profiler's count of ``lss_topk`` kernels in the LSS pass and in the
    deep hook's runtime window (``serve_runtime_trace``)."""
    t_phase = time.perf_counter()
    n = SERVE_REQUESTS
    x, labels = data.x[:n], data.labels[:n]
    w, b = model.w_out.float(), model.b_out.float()
    eng = Engine(lambda batch: model.embed(batch["x"]), w, b, lss_cfg,
                 top_k=TOP_K, head="lss", audit_rate=1.0)
    # a backlog that holds a whole pass: no sampled group is shed, so the
    # auditor's counts cover every LSS group of the pass
    eng.auditor.close()
    eng.auditor = RecallAuditor(eng, 1.0, queue_cap=n)
    eng._set_index(index)
    kinds, buckets = ("lss", "full"), eng.batcher.buckets
    all_steps = {(k, bk): 1 for k in kinds for bk in buckets}

    # the counted run: build every step (eager warm-up, capture, one
    # replay), then the LSS pass under the profiler.  A wrapper counts the
    # launches it makes -- a step's warm-up and its capture -- and the
    # profiler counts the kernels the graph replays ran on the device.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()           # reserved memory: the builds' own
    mem0 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    n_log = len(registry.dispatch_log())
    reserved_by_step = {}
    reset(counters)
    t0 = time.perf_counter()
    for kind in kinds:
        for bk in buckets:
            r0 = torch.cuda.memory_reserved()
            eng._step(kind, bk)({"x": x[:bk]})
            torch.cuda.synchronize()
            reserved_by_step[f"{kind}:{bk}"] = \
                (torch.cuda.memory_reserved() - r0) / 2 ** 20
    build_s = time.perf_counter() - t0
    mem1 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    require(eng.compile_counts == all_steps
            and all(eng._step(k, bk).captured for k, bk in all_steps),
            "serve_engine: not one captured step per (head, bucket)")
    dispatches = sorted({f"{op}:{impl}"
                         for op, impl in registry.dispatch_log()[n_log:]})
    emit({"phase": "serve_engine_build", "heads": kinds,
          "buckets": buckets, "steps": len(all_steps),
          "seconds": build_s,
          "allocated_mb_before": mem0[0] / 2 ** 20,
          "allocated_mb_after": mem1[0] / 2 ** 20,
          "reserved_mb_before": mem0[1] / 2 ** 20,
          "reserved_mb_after": mem1[1] / 2 ** 20,
          "reserved_delta_mb_by_step": reserved_by_step,
          "dispatches": dispatches, "device": smi})
    require("lss_topk:cuda" in dispatches,
            "serve_engine: the builds' dispatch log shows no lss_topk:cuda")

    # the score path, LSS head
    eng.reset_metrics()
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lss_res, sizes = serve_pattern(eng, x, labels, 0)
        torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    launches = read(counters)
    m_lss = eng.metrics()
    device_launches = device_kernel_count(prof, "lss_topk")
    window_breakdown(prof, "serve_engine_lss", smi)
    del prof
    eng.auditor.drain(timeout=600.0)
    audit = eng.auditor.snapshot()
    audit_gauge = eng.auditor._g_recall.value
    require([r.rid for r in lss_res] == list(range(n)), "serve_engine: rids")
    require(launches == {"simhash_codes_cuda": 0,
                         "lss_topk_cuda": 2 * len(buckets),
                         "bucket_logits_cuda": 0},
            f"serve_engine: wrapper launches {launches}, not a warm-up and "
            f"a capture of lss_topk for each of {len(buckets)} LSS steps")
    require(device_launches == len(sizes),
            f"serve_engine: the profiler saw {device_launches} lss_topk "
            f"kernels for {len(sizes)} groups")
    lss_lg, lss_ids = stack_results(lss_res)

    with uncounted(counters):
        q = torch.cat([model.embed(torch.from_numpy(x[i:i + BATCH]).to(dev))
                       for i in range(0, n, BATCH)])
        ref = [lss_forward(q[i:i + BATCH], index, None, TOP_K)
               for i in range(0, n, BATCH)]
        ref_lg = torch.cat([r.top_logits for r in ref]).cpu().numpy()
        ref_ids = torch.cat([r.top_ids for r in ref]).cpu().numpy()
        cand = torch.cat([r.cand_ids for r in ref])
        n_sample = int(dedup_mask(cand).sum())
        lab = torch.from_numpy(labels).to(dev)
        valid = lab >= 0
        found = (lab[:, :, None] == cand[:, None, :]).any(-1) & valid
        hits, n_labels = int(found.sum()), int(valid.sum())
        require(same_bits(lss_lg, ref_lg) and same_bits(lss_ids, ref_ids),
                "serve_engine: LSS results differ from lss_forward")
        require(n_sample == int(torch.cat([r.sample_size for r in ref])
                                .sum()), "serve_engine: sample sizes")
        require(m_lss.avg_sample_size == n_sample / n
                and m_lss.label_recall == hits / n_labels,
                "serve_engine: metrics differ from the candidates' counts")

        # the full head, the same groups
        full_res, _ = serve_pattern(eng, x, labels, 0, head="full")
        full_lg, full_ids = stack_results(full_res)
        want = [topk_lowest_index(q[i:i + BATCH] @ w.T + b, TOP_K + 1)
                for i in range(0, n, BATCH)]
        want_lg = torch.cat([v for v, _ in want]).cpu().numpy()
        want_ids = torch.cat([i for _, i in want]).cpu().numpy()
        scale = logit_scale(torch.from_numpy(want_lg[:, :TOP_K]))
        full_err = assert_close(full_lg, want_lg[:, :TOP_K],
                                rtol=LOGIT_RTOL, atol=LOGIT_ATOL * scale,
                                what="serve_engine full-head logits")
        full_checked = assert_topk_ids_equal(
            full_ids, want_ids[:, :TOP_K], want_lg[:, :TOP_K],
            TIE_TOL * scale, next_logit=want_lg[:, TOP_K],
            what="serve_engine full-head ids")

        # the auditor re-ranked every LSS group through the full head's
        # step of the same bucket: its counts are the full pass's
        hit = (full_ids[:, :, None] == lss_ids[:, None, :]).any(-1)
        require(audit == (int(hit.sum()), hit.size)
                and audit_gauge == hit.sum() / hit.size,
                f"serve_engine: auditor {audit} != full head "
                f"{(int(hit.sum()), hit.size)}")

        # a second arrival pattern: every step is reused
        _, sizes2 = serve_pattern(eng, x, labels, 1, max_group=129)
        require(eng.compile_counts == all_steps,
                f"serve_engine: builds {eng.compile_counts}")
        eng.auditor.drain(timeout=600.0)

        # host ms per group: graph replay against the eager head
        timing = []
        for kind in kinds:
            head_fn = eng._head(kind)
            for bk in buckets:
                xb = x[:bk]
                step = eng._step(kind, bk)
                timing.append({
                    "head": kind, "bucket": bk,
                    "graph_ms": host_ms(lambda: step({"x": xb})),
                    "eager_ms": host_ms(lambda: head_fn(model.embed(
                        torch.from_numpy(xb).to(dev))))})
    emit({"phase": "serve_engine", "model": model.cfg.name,
          "output_dim": w.shape[0], "requests": n,
          "rows": f"training rows 0-{n - 1}", "groups": len(sizes),
          "group_sizes": {"min": min(sizes), "max": max(sizes)},
          "seconds_under_profiler": score_s, "metrics": m_lss._asdict(),
          "wrapper_launches": launches,
          "profiler_lss_topk_kernels": device_launches,
          "lss_vs_lss_forward": "bit-identical",
          "sample_total": n_sample, "label_hits": hits,
          "labels": n_labels, "full_head_max_abs_err": full_err,
          "full_head_ids_checked": full_checked,
          "full_head_ids": int(full_ids.size),
          "audit": {"hits": audit[0], "total": audit[1],
                    "recall_at_k": audit[0] / audit[1],
                    "dropped": eng.auditor.reg.counter(
                        "lss_audit_dropped_total").value},
          "second_pattern_groups": len(sizes2),
          "compile_counts": {f"{k}:{bk}": v
                             for (k, bk), v in eng.compile_counts.items()},
          "device": smi})
    emit({"phase": "serve_engine_timing", "what": "host-clock ms a group, "
          "synchronised, median of 20: the step (copy in, replay, clone) "
          "against the eager embed + head", "rows": timing, "device": smi})

    # the async runtime: staged, then open loop, then a burst
    eng.auditor.drain(timeout=600.0)
    for j in range(n):                       # flush's grouping: 128s
        eng.submit({"x": x[j]}, labels=labels[j])
    sync = stack_results(eng.flush())
    require(same_bits(sync[0], lss_lg) and same_bits(sync[1], lss_ids),
            "serve_engine: a row's result depends on its group")
    runs = {"paused": runtime_run(eng, x, labels, 0.0, start=False),
            "open_loop": runtime_run(eng, x, labels, SERVE_QPS),
            "burst": runtime_run(eng, x, labels, 0.0)}
    # the same open loop without the auditor: what auditing every chunk
    # costs the runtime's latency
    auditor, eng.auditor = eng.auditor, None
    runs["open_loop_no_audit"] = runtime_run(eng, x, labels, SERVE_QPS)
    eng.auditor = auditor
    stats = {}
    for name, (res, s) in runs.items():
        lg, ids = stack_results(res)
        require(same_bits(lg, lss_lg) and same_bits(ids, lss_ids),
                f"serve_engine: the {name} runtime's results differ from "
                f"the flush's")
        require(s.n_completed == n and s.n_shed_queue == 0
                and s.n_shed_deadline == 0, f"serve_engine: {name} shed")
        stats[name] = s._asdict()
    emit({"phase": "serve_engine_runtime", "requests": n,
          "open_loop_qps": SERVE_QPS, "results": "bit-identical to flush",
          **stats, "device": smi})
    runtime_launches = serve_runtime_trace(dev, smi, eng, x, labels, lss_lg,
                                           lss_ids)

    # observability: the Prometheus text of every registry, the trace
    eng.auditor.drain(timeout=600.0)
    text = prometheus_text()
    families, errors = parse_exposition(text)
    require(not errors, f"serve_engine: exposition errors {errors[:3]}")
    require({"lss_audit_recall_at_k", "engine_request_latency_seconds",
             "runtime_request_latency_seconds"} <= set(families),
            "serve_engine: metric families missing")
    eng.auditor.close()
    with tempfile.TemporaryDirectory(prefix="serve_trace_") as tmp:
        trace = trace_export(str(Path(tmp) / "trace.json"))
        trace_bytes = (Path(tmp) / "trace.json").stat().st_size
    assert_quiescent()
    print(text, end="", flush=True)
    emit({"phase": "serve_engine_obs", "families": len(families),
          "lines": text.count("\n"), "trace_events":
          len(trace["traceEvents"]), "trace_bytes": trace_bytes,
          "seconds": time.perf_counter() - t_phase})
    return device_launches, runtime_launches


def serve_runtime_trace(dev, smi, eng, x, labels, lss_lg, lss_ids):
    """One second of the open loop (``SERVE_QPS`` requests, ``x``'s rows
    in turn; no auditor, whose default rate is 0) under the deep hook,
    ``obs.maybe_profile``: the trace file parses, its ``lss_topk``
    kernels are one a dispatched chunk and the profiler's own count, its
    host events include the runtime's dispatcher and completion threads,
    and every result is the flush's.  Prints the window's breakdown and
    returns its ``lss_topk`` kernels."""
    n = int(SERVE_QPS)
    rows = np.arange(n) % x.shape[0]
    auditor, eng.auditor = eng.auditor, None
    with tempfile.TemporaryDirectory(prefix="serve_runtime_") as tmp:
        t0 = time.perf_counter()
        with maybe_profile(tmp, "serve_runtime", device=dev) as prof:
            rt = AsyncRuntime(eng, max_queue=4 * n, policy="block")
            futs, _ = submit_open_loop(rt, [{"x": r} for r in x[rows]],
                                       SERVE_QPS, seed=0, labels=labels[rows])
            rt.drain(timeout=600.0)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        res = [f.result(timeout=60.0) for f in futs]
        stats = rt.stats()
        rt.close(timeout=60.0)
        eng.auditor = auditor
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
        breakdown = window_breakdown(prof, "serve_runtime", smi, trace=prof)
        profiled = device_kernel_count(prof, "lss_topk")
        del prof
    traced = sum(1 for e in events
                 if e.get("cat") == "kernel" and "lss_topk" in e["name"])
    threads = {"dispatch": rt._threads[0].native_id,
               "complete": rt._threads[1].native_id}
    host_events = {name: sum(1 for e in events
                             if e.get("ph") == "X" and e.get("tid") == tid
                             and e.get("cat") != "kernel")
                   for name, tid in threads.items()}
    lg, ids = stack_results(res)
    require(same_bits(lg, lss_lg[rows]) and same_bits(ids, lss_ids[rows]),
            "serve_runtime: results differ from the flush's")
    require(stats.n_completed == n and stats.n_shed_queue == 0
            and stats.n_shed_deadline == 0, "serve_runtime: shed")
    require(traced == profiled == stats.n_batches,
            f"serve_runtime: the trace holds {traced} lss_topk kernels, the "
            f"profiler {profiled}, for {stats.n_batches} chunks")
    require(all(host_events.values()),
            f"serve_runtime: host events by runtime thread {host_events}")
    emit({"phase": "serve_runtime_trace", "requests": n, "qps": SERVE_QPS,
          "seconds": seconds, "trace_events": len(events),
          "trace_lss_topk_kernels": traced, "chunks": stats.n_batches,
          "host_events_by_thread": host_events, "stats": stats._asdict(),
          "trace_bytes": breakdown["trace_bytes"],
          "export_s": breakdown["export_s"], "device": smi})
    return traced


# ------------------------------------------------ vocab-sharded serving --

def run_fleet(cmds, timeout, what):
    """Start every command at once from the repository root and wait for
    all; a fleet that outlives ``timeout`` is killed and fails the run.
    Returns each process's exit code and output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, t_end = [], time.monotonic() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, t_end - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"{what}: the fleet outlived {timeout} s and was "
                           f"killed") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_sharded_index(dev, smi, model, index, lss_cfg, data, counters):
    """``shard_index`` of ``train_wol``'s trained WOL into 1, 2 and 4
    vocab shards, with fp32 and int8 slabs (205,443 is odd: the last of 2
    and of 4 shards has a 1-row padded tail).  The counted run: the
    in-process oracle (``make_sharded_predict`` over a one-process mesh:
    each shard's ``lss_topk``, then the merge) once on the first 256
    training rows, one ``lss_topk`` launch a shard.  Outside the counts:
    each shard's ``lss_topk`` against its plain version per the parity
    contract, no padded id in any shard's candidates or winners, the
    1-shard head bit for bit the ``lss`` head, and device ms of each
    shard's kernel, of the merge and of the whole oracle.  Returns the
    wrapper launches of the counted runs."""
    t_phase = time.perf_counter()
    w_aug = augment_neurons(model.w_out, model.b_out)
    m = w_aug.shape[0]
    theta = index.theta
    q = model.embed(torch.from_numpy(data.x[:BATCH]).to(dev))
    q_aug = augment_queries(q)
    launches, n_rows, n_excl = {}, 0, 0
    for n in SHARD_COUNTS:
        for sdt in ("fp32", "int8"):
            cfg = lss_cfg._replace(slab_dtype=sdt)
            t0 = time.perf_counter()
            stack, _, m_local = shard_index(w_aug, theta, cfg, n)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            mesh = ServingMesh.local(n, dev)
            fwd = make_sharded_predict(mesh, m_local, TOP_K, with_aux=True)
            reset(counters)
            logits, ids, sample = fwd(q, stack)
            key = f"{n}:{sdt}"
            launches[key] = read(counters)
            require(launches[key]["lss_topk_cuda"] == n,
                    f"sharded_index {key}: launches {launches[key]}")
            require(bool(((ids >= -1) & (ids < m)).all()),
                    f"sharded_index {key}: a merged id outside the vocab")
            with uncounted(counters):
                shards = []
                for s, idx in enumerate(stack):
                    t = idx.tables
                    n_valid = min(max(m - s * m_local, 0), m_local)
                    args = (q_aug, theta, t.table_ids, idx.w_bucketed)
                    rows, check, got = compare_lss_topk(*args, idx.w_scale,
                                                        TOP_K)
                    require(int(got[3].max()) < n_valid
                            and int(got[1].max()) < n_valid
                            and int(t.table_ids.max()) < n_valid,
                            f"sharded_index {key} shard {s}: a padded id")
                    n_rows += q_aug.shape[0]
                    n_excl += int((~rows).sum())
                    shards.append({
                        "shard": s, "rows": n_valid,
                        "padded_rows": m_local - n_valid, "P": t.capacity,
                        "n_dropped": int(t.n_dropped.sum()),
                        "excluded_rows": int((~rows).sum()), **check,
                        "ms": time_ms(lambda: lss_topk(
                            *args, top_k=TOP_K, w_scale=idx.w_scale))})
                part = local_part(q, stack, None, k=TOP_K, shard0=0,
                                  m_local=m_local)
                merge_ms = time_ms(lambda: topk_merge(part.logits,
                                                      part.gids, TOP_K))
                oracle_ms = time_ms(lambda: fwd(q, stack))
                same_as_lss = None
                if n == 1:
                    ref_index = (index if sdt == "fp32" else
                                 build_index(w_aug, theta, cfg))
                    a = make_sharded_lss_head(stack, None, mesh, m_local,
                                              TOP_K)(q)
                    b = make_lss_head(ref_index, None, TOP_K)(q)
                    same_as_lss = all(same_tensor_bits(x, y)
                                      for x, y in zip(a[:3], b[:3]))
                    require(same_as_lss, f"sharded_index {key}: the 1-shard "
                            f"head differs from the lss head")
            emit({"phase": "sharded_index", "n_shards": n,
                  "slab_dtype": sdt, "m": m, "m_local": m_local,
                  "build_s": build_s, "shards": shards,
                  "mean_sample": float(sample.float().mean()),
                  "merge_ms": merge_ms, "oracle_ms": oracle_ms,
                  "one_shard_head_is_lss_head": same_as_lss,
                  "launches": launches[key], "device": smi})
            del stack, part
    require(n_excl < MAX_EXCLUDED_FRAC * n_rows,
            f"sharded_index: {n_excl} of {n_rows} rows lack the margin")
    emit({"phase": "sharded_index_done",
          "seconds": time.perf_counter() - t_phase})
    return launches


def phase_sharded_engine(dev, smi, model, index, lss_cfg, data, counters):
    """``Engine(head="lss-sharded")`` on a process group of one rank over
    NCCL: every (lss-sharded, bucket) step captured (the graph ends at
    the shard's winners; the NCCL gather, the merge and the sample sum
    run after the replay), then ``SERVE_REQUESTS`` training rows in
    ragged groups under ``torch.profiler`` (one ``lss_topk`` kernel a
    group), bit for bit the ``lss`` head's results on the same groups,
    and host ms a group at each bucket beside the ``lss`` head's.
    Returns the profiler's ``lss_topk`` count."""
    t_phase = time.perf_counter()
    require(init_distributed(f"127.0.0.1:{free_port()}", 1, 0),
            "sharded_engine: no process group")
    try:
        n = SERVE_REQUESTS
        x, labels = data.x[:n], data.labels[:n]
        eng = Engine(lambda batch: model.embed(batch["x"]),
                     model.w_out.float(), model.b_out.float(), lss_cfg,
                     top_k=TOP_K, head="lss-sharded", audit_rate=0.0)
        eng._set_index(index)
        mesh = eng._get_mesh()
        require(mesh.backend == "nccl" and mesh.world == 1
                and mesh.group is not None,
                f"sharded_engine: mesh {mesh}")
        buckets = eng.batcher.buckets
        reset(counters)
        t0 = time.perf_counter()
        for kind in ("lss-sharded", "lss"):
            for bk in buckets:
                eng._step(kind, bk)({"x": x[:bk]})
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        require(all(eng._step(k, bk).captured for k in ("lss-sharded", "lss")
                    for bk in buckets), "sharded_engine: a step not captured")
        from torch.profiler import ProfilerActivity, profile
        eng.reset_metrics()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res, sizes = serve_pattern(eng, x, labels, 0)
            torch.cuda.synchronize()
        launches = read(counters)
        device_launches = device_kernel_count(prof, "lss_topk")
        nccl_kernels = device_kernel_count(prof, "nccl")
        m_sh = eng.metrics()
        require(launches["lss_topk_cuda"] == 4 * len(buckets),
                f"sharded_engine: wrapper launches {launches}, not a warm-up "
                f"and a capture of lss_topk for each of {2 * len(buckets)} "
                f"steps")
        require(device_launches == len(sizes),
                f"sharded_engine: the profiler saw {device_launches} "
                f"lss_topk kernels for {len(sizes)} groups")
        with uncounted(counters):
            eng.reset_metrics()
            lss_res, _ = serve_pattern(eng, x, labels, 0, head="lss")
            sh_lg, sh_ids = stack_results(res)
            lss_lg, lss_ids = stack_results(lss_res)
            require(same_bits(sh_lg, lss_lg) and same_bits(sh_ids, lss_ids),
                    "sharded_engine: lss-sharded results differ from lss")
            m_lss = eng.metrics()
            timing = []
            for bk in buckets:
                xb = {"x": x[:bk]}
                s_sh, s_lss = eng._step("lss-sharded", bk), eng._step("lss",
                                                                      bk)
                timing.append({"bucket": bk,
                               "lss_sharded_ms": host_ms(lambda: s_sh(xb)),
                               "lss_ms": host_ms(lambda: s_lss(xb))})
        emit({"phase": "sharded_engine", "backend": mesh.backend,
              "world": mesh.world, "requests": n, "groups": len(sizes),
              "build_s": build_s, "wrapper_launches": launches,
              "profiler_lss_topk_kernels": device_launches,
              "profiler_nccl_kernels": nccl_kernels,
              "lss_sharded_vs_lss": "bit-identical",
              "avg_sample_size": m_sh.avg_sample_size,
              "avg_sample_size_lss": m_lss.avg_sample_size,
              "host_ms_a_group": timing,
              "seconds": time.perf_counter() - t_phase, "device": smi})
        del eng
    finally:
        shutdown_distributed()
    return device_launches


def fleet_worker(rank: int, tmp: str, port: int) -> int:
    """One rank of the ``fleet`` phase (``chip_smoke.py --fleet-worker
    RANK DIR PORT``): two processes on the one card, 2 hosts of 1 rank
    over gloo.  Both ranks: ``shard_index`` of ONLY their own rows (read
    from the WOL in DIR) and ``make_multihost_predict`` on every query,
    bit for bit the oracle; the merge alone timed.  Then an
    ``Engine(spmd=...)``: the leader serves every query through ``rank``
    and through the AsyncRuntime at ``FLEET_QPS``, swaps to θ2 (bit for
    bit a cold engine on it), fails a swap to θ3 at
    ``MULTIHOST_SWAP_COMMIT``, and stops the follower, which replays its
    opcodes.  Each rank's serving window (the leader's from ``rank`` to
    the aborted swap, the follower's ``follower_loop``) runs under
    ``torch.profiler``, whose ``lss_topk`` kernels must be one a group
    served plus one a step build.  Prints one ``FLEET {...}`` line."""
    d = Path(tmp)
    cfg = LSSConfig(**json.loads((d / "config.json").read_text()))
    ctx = init_multihost(f"127.0.0.1:{port}", 2, rank)
    require(ctx is not None and ctx.mesh.backend == "gloo"
            and (ctx.mesh.n_hosts, ctx.mesh.ranks_per_host) == (2, 1),
            f"fleet rank {rank}: {ctx and ctx.mesh}")
    dev = ctx.mesh.device
    w_np = np.load(d / "w.npy", mmap_mode="r")
    b_np = np.load(d / "b.npy")
    thetas = torch.from_numpy(np.load(d / "theta.npy")).to(dev)
    q = np.load(d / "q.npy")
    oracle = np.load(d / "oracle.npz")
    m, n = w_np.shape[0], q.shape[0]
    qt = torch.from_numpy(q).to(dev)
    counter = lss_topk_ops.lss_topk_cuda
    report = {"rank": rank, "device": str(dev),
              "backend": ctx.mesh.backend}

    # 1. only this rank's rows: the shard of shard_range, lockstep predict
    r0, r1 = ctx.row_range(m)
    t0 = time.perf_counter()
    w_aug = augment_neurons(
        torch.from_numpy(np.ascontiguousarray(w_np[r0:r1])).to(dev),
        torch.from_numpy(b_np[r0:r1]).to(dev))
    local, _, m_local = shard_index(w_aug, thetas[0], cfg, ctx.n_shards,
                                    shard_range=ctx.shard_range(),
                                    m_total=m)
    torch.cuda.synchronize()
    report["shard_build_s"] = time.perf_counter() - t0
    report["rows"] = [r0, r1]
    fwd = make_multihost_predict(ctx.mesh, m_local, TOP_K, with_aux=True)
    outs = [fwd(qt[i:i + BATCH], local) for i in range(0, n, BATCH)]
    got = [torch.cat(o).cpu().numpy() for o in zip(*outs)]
    require(all(same_bits(g, oracle[f"{k}0"]) for g, k in
                zip(got, ("logits", "ids", "sample"))),
            f"fleet rank {rank}: multihost predict differs from the oracle")
    part = local_part(qt[:128], local, None, k=TOP_K,
                      shard0=ctx.shard_range()[0], m_local=m_local)
    times = []
    for _ in range(TIME_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multihost_merge(part, TOP_K, ctx.mesh)
        times.append((time.perf_counter() - t0) * 1e3)
    report["merge_ms_b128"] = float(np.median(times))
    del local, w_aug, part

    # 2. the engine: the leader serves, the follower replays
    eng = Engine(None, torch.from_numpy(np.asarray(w_np)).to(dev),
                 torch.from_numpy(b_np).to(dev), cfg, top_k=TOP_K,
                 head="lss-sharded", spmd=ctx)
    eng._set_index(build_index(eng._w_aug, thetas[0], cfg))
    counter.launches = 0
    # the serving window runs under torch.profiler on both ranks: its
    # lss_topk kernels must be one a group served (a graph replay) plus
    # one a step build (the eager warm-up; the capture runs nothing)
    from torch.profiler import ProfilerActivity, profile
    window = profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA])
    if ctx.is_leader:
        def check(out, k, what):
            require(same_bits(out.logits.cpu().numpy(), oracle[f"logits{k}"])
                    and same_bits(out.ids.cpu().numpy(), oracle[f"ids{k}"]),
                    f"fleet: {what} differs from the oracle")

        with window:
            t0 = time.perf_counter()
            check(eng.rank(q), 0, "rank")
            report["rank_s"] = time.perf_counter() - t0
            rt = AsyncRuntime(eng, max_queue=4 * n, policy="block")
            futs, _ = submit_open_loop(rt, list(q), FLEET_QPS, seed=0)
            rt.drain(timeout=300.0)
            res = [f.result(timeout=60.0) for f in futs]
            stats = rt.stats()
            rt.close(timeout=60.0)
            lg, ids = stack_results(res)
            require(same_bits(lg, oracle["logits0"])
                    and same_bits(ids, oracle["ids0"]),
                    "fleet: the runtime's results differ from the oracle")
            require(stats.n_completed == n and stats.n_shed_queue == 0
                    and stats.n_shed_deadline == 0, "fleet: the runtime shed")
            report["runtime"] = {
                k: getattr(stats, k) for k in (
                    "n_completed", "throughput_rps", "latency_p50_ms",
                    "latency_p95_ms", "latency_p99_ms",
                    "avg_batch_occupancy")}
            e1 = eng.index_epoch
            t0 = time.perf_counter()
            e2 = eng.swap_index(build_index(eng._w_aug, thetas[1], cfg))
            report["swap_s"] = time.perf_counter() - t0
            check(eng.rank(q), 2, "rank after the swap")
            try:
                with faults.injected(faults.MULTIHOST_SWAP_COMMIT,
                                     RuntimeError("failed before commit")):
                    eng.swap_index(build_index(eng._w_aug, thetas[2], cfg))
                raise SmokeFailure("fleet: the injected swap went through")
            except RuntimeError:
                pass
            require(eng.index_epoch == e2 > e1,
                    f"fleet: epochs {e1} -> {e2} -> {eng.index_epoch}")
            check(eng.rank(q), 2, "rank after the aborted swap")
            torch.cuda.synchronize()
        # every message in the window but the two swaps' payload and
        # commit flag is a group served
        groups = ctx.channel.seq - 2 * 2
        builds, launches = eng.n_builds(), counter.launches
        # timed outside the leader's window (the follower's replays of
        # these groups stay in its own)
        report["host_ms_b128"] = host_ms(
            lambda: eng.rank(q[:128], record=False))
        stop_followers(ctx)
        # every message but STOP and the two swaps' commit flags is an op
        report["ops"] = ctx.channel.seq - 1 - 2
    else:
        with window:
            report["ops"] = follower_loop(eng, ctx)
            torch.cuda.synchronize()
        groups = report["ops"] - 2           # less the two OP_SWAP_INDEX
        builds, launches = eng.n_builds(), counter.launches
    device = device_kernel_count(window, "lss_topk")
    require(launches == 2 * builds,
            f"fleet rank {rank}: wrapper launches {launches}, not a warm-up "
            f"and a capture for each of {builds} step builds")
    require(device == groups + builds,
            f"fleet rank {rank}: the profiler saw {device} lss_topk kernels "
            f"for {groups} groups and {builds} step builds")
    torch.cuda.synchronize()
    report.update(epoch=eng.index_epoch, messages=ctx.channel.seq,
                  groups=groups, step_builds=builds,
                  lss_topk_launches=launches,
                  profiler_lss_topk_kernels=device,
                  max_allocated_mb=torch.cuda.max_memory_allocated(dev)
                  / 2 ** 20,
                  reserved_mb=torch.cuda.memory_reserved(dev) / 2 ** 20)
    del eng
    shutdown_distributed()
    print("FLEET " + json.dumps(report), flush=True)
    return 0


def phase_fleet(dev, smi, model, index, lss_cfg, data):
    """Two processes share the one card over gloo, as 2 hosts of 1 rank
    (so the two-stage merge runs): ``fleet_worker`` on the trained WOL,
    which this process writes to a temporary directory with the first
    ``SERVE_REQUESTS`` training rows' embeddings, three θ (the trained
    one, θ2 and θ3 from a seeded generator) and the oracle: a cold
    one-process engine over 2 shards (``ServingMesh.local(2)``) on θ and
    θ2.  Checks both ranks' reports: every result bit for bit the oracle,
    the follower's ops and messages the leader's, every rank on the
    committed epoch after the aborted swap.  Returns the ranks' reports."""
    t_phase = time.perf_counter()
    n = SERVE_REQUESTS
    w, b = model.w_out.float(), model.b_out.float()
    q = torch.cat([model.embed(torch.from_numpy(data.x[i:i + BATCH]).to(dev))
                   for i in range(0, n, BATCH)])
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    thetas = [index.theta] + [
        init_hyperplanes(gen, w.shape[1] + 1, lss_cfg.k_bits,
                         lss_cfg.n_tables, device=dev) for _ in range(2)]
    oracle = {}
    for k in (0, 1):
        cold = Engine(None, w, b, lss_cfg, top_k=TOP_K, head="lss-sharded",
                      mesh=ServingMesh.local(2, dev), audit_rate=0.0)
        cold._set_index(build_index(cold._w_aug, thetas[k], lss_cfg))
        out = cold.rank(q, record=False)
        tag = "0" if k == 0 else "2"
        oracle.update({f"logits{tag}": out.logits.cpu().numpy(),
                       f"ids{tag}": out.ids.cpu().numpy(),
                       f"sample{tag}": out.sample_size.cpu().numpy()})
        del cold
    with tempfile.TemporaryDirectory(prefix="fleet_") as tmp:
        d = Path(tmp)
        np.save(d / "w.npy", w.cpu().numpy())
        np.save(d / "b.npy", b.cpu().numpy())
        np.save(d / "q.npy", q.cpu().numpy())
        np.save(d / "theta.npy", torch.stack(thetas).cpu().numpy())
        np.savez(d / "oracle.npz", **oracle)
        (d / "config.json").write_text(json.dumps(lss_cfg._asdict()))
        wol_mb = (d / "w.npy").stat().st_size / 2 ** 20
        port = free_port()
        t0 = time.perf_counter()
        rcs, outs = run_fleet(
            [[sys.executable, str(ROOT / "chip_smoke.py"), "--fleet-worker",
              str(r), tmp, str(port)] for r in range(2)],
            FLEET_TIMEOUT_S, "fleet")
        fleet_s = time.perf_counter() - t0
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        require(rc == 0, f"fleet: rank {r} exited {rc}:\n{out[-4000:]}")
    reports = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("FLEET ")]
        require(lines, f"fleet: no report in\n{out[-3000:]}")
        reports.append(json.loads(lines[-1][len("FLEET "):]))
    lead, follow = reports
    require(follow["ops"] == lead["ops"]
            and follow["messages"] == lead["messages"],
            f"fleet: follower {follow['ops']} ops / {follow['messages']} "
            f"messages, leader {lead['ops']} / {lead['messages']}")
    require(follow["epoch"] == lead["epoch"],
            f"fleet: epochs {lead['epoch']} / {follow['epoch']}")
    require(all(r["profiler_lss_topk_kernels"] > 0 for r in reports),
            "fleet: a rank ran no lss_topk")
    emit({"phase": "fleet", "processes": 2, "hosts": 2, "backend": "gloo",
          "requests": n, "qps": FLEET_QPS, "wol_mb": wol_mb,
          "results": "bit-identical to the one-process 2-shard oracle",
          "fleet_s": fleet_s, "reports": reports,
          "seconds": time.perf_counter() - t_phase, "device": smi})
    return reports


# ------------------------------------------------------- sharded train --

def sharded_train_setup():
    """``train_wol``'s full-width XC model, rows and TrainConfig (no
    checkpoints), and the generator seed both runs draw the parameters
    from."""
    cfg = DELICIOUS.full._replace(max_in=32, max_labels=4)
    data = xc_dataset(11, 6616, cfg.input_dim, cfg.output_dim, n_topics=128,
                      max_in=cfg.max_in, max_labels=cfg.max_labels)
    tc = TrainConfig(lr=5e-3, warmup_steps=30, total_steps=500,
                     weight_decay=0.0, ckpt_every=10 ** 9)
    return cfg, {"x": data.x, "labels": data.labels}, tc


def state_bytes(state) -> int:
    """This rank's bytes of a train state (its pieces of sharded leaves)."""
    return sum(t.numel() * t.element_size()
               for t in map(to_local, tree_leaves(state)))


def timed_steps(step_fn, state, batch, mesh=None, iters=STEP_ITERS):
    """Host ms of ``iters`` synchronised steps that do not donate (the
    state stays as it is)."""
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with use_mesh(mesh):
            step_fn(state, batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t1) * 1e3)
    return out


def train_worker(rank: int, tmp: str, port: int) -> int:
    """One rank of the ``sharded_train`` phase (``chip_smoke.py
    --train-worker RANK DIR PORT``): two processes on the one card over
    gloo.  (1) The full-width XC model on a (1, 2) mesh for
    ``SHARDED_STEPS`` steps from the seeded parameters: losses, ms a
    step, this rank's state bytes and peak memory, one step's
    collectives; then this rank builds the index of ITS OWN trained WOL
    rows (``shard_index`` with its shard range) on a seeded θ and serves
    ``SHARDED_QUERIES`` rows through ``lss_topk`` and the serving merge;
    rank 0 writes the gathered WOL and the queries for the one-process
    oracle.  (2) The same model on (2, 1), ``DP_STEPS`` steps, then
    ``compressed_psum`` of each rank's own gradient of its half batch
    over the data group against the fp32 mean.  Prints one
    ``SHARDED_TRAIN {...}`` line."""
    faulthandler.enable()           # a crash in a collective names its line
    d = Path(tmp)
    require(init_distributed(f"127.0.0.1:{port}", 2, rank),
            "sharded_train: no fleet")

    def stage(name):
        print(f"sharded_train rank {rank}: {name}", flush=True)

    cfg, data, tc = sharded_train_setup()
    lss_cfg = DELICIOUS.lss
    counter = lss_topk_ops.lss_topk_cuda
    report = {"rank": rank}
    try:
        tm = make_training_mesh((1, 2))
        dev = tm.device
        report.update(backend=tm.backend, device=str(dev))
        require(tm.backend == "gloo" and stages_gathers(tm.mesh),
                f"sharded_train rank {rank}: backend {tm.backend}")
        loss = lambda p, b: xc.loss(p, b, cfg)   # noqa: E731
        init = lambda g: xc.init_params(g, cfg, dev)   # noqa: E731

        # 1. model-sharded: the WOL rows and the input table over model
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(loss, init, tc, mesh=tm.mesh,
                     param_specs=xc.param_specs(cfg))
        it = ShardedBatchIterator(data, BATCH, mesh=tm.mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, hist = tr.fit(torch.Generator(dev).manual_seed(SEED + 20),
                             it, SHARDED_STEPS, log_every=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        batch = next(it)
        step_fn = make_train_step(loss, tc)
        # CollectiveLog imports DTensor's debug tools: only this worker
        from repro_torch.utils.sharding import CollectiveLog
        with use_mesh(tm.mesh), CollectiveLog() as log:
            step_fn(state, batch)
            torch.cuda.synchronize()
        stage("(1, 2) trained")
        report["model_sharded"] = {
            "losses": [h["loss"] for h in hist], "fit_s": fit_s,
            "ms_per_step": timed_steps(step_fn, state, batch, tm.mesh),
            "state_bytes": state_bytes(state), "peak_allocated_mb": peak_mb,
            "local_rows": {k: list(to_local(v).shape)
                           for k, v in state.params.items()},
            "collectives": log.summary(),
            "collective_shapes": [[r["op"], r["output"]]
                                  for r in log.records]}

        # the served shard: this rank's trained rows only
        m = cfg.output_dim
        w_local = to_local(state.params["w_out"])
        b_local = to_local(state.params["b_out"])
        model = XCModel.from_params(state.params, cfg)
        with use_mesh(tm.mesh):
            q = to_local(model.embed(named_sharding(tm.mesh, P()).place(
                torch.from_numpy(data["x"][:SHARDED_QUERIES]))))
        stage("queries embedded")
        w_full = full_tensor(state.params["w_out"])
        b_full = full_tensor(state.params["b_out"])
        stage("WOL gathered")
        if rank == 0:
            np.save(d / "w.npy", w_full.cpu().numpy())
            np.save(d / "b.npy", b_full.cpu().numpy())
            np.save(d / "q.npy", q.cpu().numpy())
        del w_full, b_full, model
        smesh = make_serving_mesh()
        theta = init_hyperplanes(torch.Generator(dev).manual_seed(SEED + 21),
                                 cfg.hidden + 1, lss_cfg.k_bits,
                                 lss_cfg.n_tables, device=dev)
        r0, r1 = smesh.row_range(m)
        require(w_local.shape[0] == r1 - r0,
                f"sharded_train rank {rank}: {w_local.shape[0]} trained "
                f"rows, the serving shard holds [{r0}, {r1})")
        local, _, m_local = shard_index(augment_neurons(w_local, b_local),
                                        theta, lss_cfg, smesh.n_shards,
                                        shard_range=smesh.shard_range(),
                                        m_total=m)
        stage("shard index built")
        fwd = make_sharded_predict(smesh, m_local, TOP_K, with_aux=True)
        torch.cuda.synchronize()
        counter.launches = 0
        out = fwd(q, local)
        torch.cuda.synchronize()
        launches = counter.launches
        np.savez(d / f"served_r{rank}.npz",
                 **{k: t.cpu().numpy()
                    for k, t in zip(("logits", "ids", "sample"), out)})
        idx = local[0]
        _, check, _ = compare_lss_topk(augment_queries(q), idx.theta,
                                       idx.tables.table_ids,
                                       idx.w_bucketed, idx.w_scale, TOP_K)
        report["served"] = {"rows": [r0, r1], "m_local": m_local,
                            "lss_topk_launches": launches,
                            "kernel_check": check}
        del state, tr, it, local, w_local, b_local
        gc.collect()
        torch.cuda.empty_cache()

        # 2. data-parallel: the whole model on each rank, the batch split
        stage("served")
        tm2 = make_training_mesh((2, 1))
        tr2 = Trainer(loss, init, tc, mesh=tm2.mesh,
                      param_specs=xc.param_specs(cfg))
        it2 = ShardedBatchIterator(data, BATCH, mesh=tm2.mesh)
        state2, hist2 = tr2.fit(torch.Generator(dev).manual_seed(SEED + 20),
                                it2, DP_STEPS, log_every=1)
        batch2 = next(it2)
        report["data_parallel"] = {
            "losses": [h["loss"] for h in hist2],
            "ms_per_step": timed_steps(make_train_step(loss, tc), state2,
                                       batch2, tm2.mesh, iters=3),
            "state_bytes": state_bytes(state2)}
        # compressed_psum of this rank's own gradient of its half batch
        stage("(2, 1) trained")
        params = {k: to_local(v) for k, v in state2.params.items()}
        _, grads = value_and_grad(loss, params,
                                  {k: to_local(v) for k, v in batch2.items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, err = compressed_psum(grads, init_error_state(grads),
                                   tm2.groups["data"])
        torch.cuda.synchronize()
        psum_s = time.perf_counter() - t0
        leaves = {}
        for k, g in grads.items():
            mean = g.clone()
            dist.all_reduce(mean, group=tm2.groups["data"])
            mean /= 2
            # int8 rounding: at most half a block's scale a rank, averaged
            _, scale = quantize_int8(g.float())
            scales = torch.empty(2 * scale.numel(), device=dev)
            dist.all_gather_into_tensor(scales, scale, group=tm2.groups["data"])
            bound = scales.reshape(2, -1).sum(0) / 4
            bound = bound[:, None].expand(-1, 256).reshape(-1)[:g.numel()]
            diff = (got[k] - mean).abs().reshape(-1)
            excess = float((diff - bound * (1 + 1e-5)
                            - 1e-6 * mean.abs().reshape(-1)).max())
            leaves[k] = {"max_abs_err": float(diff.max()),
                         "max_bound": float(bound.max()),
                         "excess_over_bound": excess,
                         "err_state_max": float(err[k].abs().max()),
                         "wire_bytes_int8": g.numel() + 4 * scale.numel(),
                         "wire_bytes_fp32": 4 * g.numel()}
            require(excess <= 0, f"sharded_train rank {rank}: "
                    f"compressed_psum {k} off the fp32 mean by more than "
                    f"the int8 bound ({excess})")
        report["compressed_psum"] = {"seconds": psum_s, "leaves": leaves}
        torch.cuda.synchronize()
    finally:
        shutdown_distributed()
    print("SHARDED_TRAIN " + json.dumps(report), flush=True)
    return 0


def phase_sharded_train(dev, smi):
    """Sharded training at Delicious-200K width: the one-process run of
    ``SHARDED_STEPS`` steps from the seeded parameters (``train_wol``'s
    rows and TrainConfig), then ``train_worker`` as two processes on the
    card over gloo: the (1, 2) run's losses within ``SHARDED_RTOL`` of
    the one-process run's, each rank holding about half the sharded
    state, no gather in its step; each rank's served shard bit for bit
    the one-process ``shard_index`` oracle on the gathered WOL; the
    (2, 1) run's losses the one-process run's first ``DP_STEPS``;
    ``compressed_psum`` within its int8 bound.  Then the train launcher
    at Qwen2-0.5B width with ``--devices 2 --mesh 1x2``, again with
    ``--mesh 2x1`` (resumes and trains on), and on one device (resumes,
    nothing left).  Returns each rank's ``lss_topk`` launches."""
    t_phase = time.perf_counter()
    cfg, data, tc = sharded_train_setup()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss = lambda p, b: xc.loss(p, b, cfg)   # noqa: E731
    tr = Trainer(loss, lambda g: xc.init_params(g, cfg, dev), tc, device=dev)
    it = ShardedBatchIterator(data, BATCH, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):    # a line a step
        state, hist = tr.fit(torch.Generator(dev).manual_seed(SEED + 20),
                             it, SHARDED_STEPS, log_every=1)
    torch.cuda.synchronize()
    one = {"losses": [h["loss"] for h in hist],
           "fit_s": time.perf_counter() - t0,
           "ms_per_step": timed_steps(make_train_step(loss, tc), state,
                                      next(it)),
           "state_bytes": state_bytes(state),
           "peak_allocated_mb": (torch.cuda.max_memory_allocated() - base)
           / 2 ** 20}
    del state, tr, it
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="sharded_train_") as tmp:
        port = free_port()
        t0 = time.perf_counter()
        rcs, outs = run_fleet(
            [[sys.executable, str(ROOT / "chip_smoke.py"), "--train-worker",
              str(r), tmp, str(port)] for r in range(2)],
            FLEET_TIMEOUT_S, "sharded_train")
        fleet_s = time.perf_counter() - t0
        for r, (rc, out) in enumerate(zip(rcs, outs)):
            require(rc == 0, f"sharded_train: rank {r} exited {rc}:\n"
                    f"{out[-4000:]}")
        reports = []
        for out in outs:
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("SHARDED_TRAIN ")]
            require(lines, f"sharded_train: no report in\n{out[-3000:]}")
            reports.append(json.loads(lines[-1][len("SHARDED_TRAIN "):]))
        d = Path(tmp)
        w = torch.from_numpy(np.load(d / "w.npy")).to(dev)
        b = torch.from_numpy(np.load(d / "b.npy")).to(dev)
        q = torch.from_numpy(np.load(d / "q.npy")).to(dev)
        served = [np.load(d / f"served_r{r}.npz") for r in range(2)]
        # the one-process oracle: both shards of the gathered WOL in this
        # process, the same θ
        theta = init_hyperplanes(torch.Generator(dev).manual_seed(SEED + 21),
                                 cfg.hidden + 1, DELICIOUS.lss.k_bits,
                                 DELICIOUS.lss.n_tables, device=dev)
        stack, _, m_local = shard_index(augment_neurons(w, b), theta,
                                        DELICIOUS.lss, 2)
        with uncounted((lss_topk_ops.lss_topk_cuda,)):
            oracle = [t.cpu().numpy() for t in make_sharded_predict(
                ServingMesh.local(2, dev), m_local, TOP_K,
                with_aux=True)(q, stack)]
        del w, b, stack
    for r, z in enumerate(served):
        require(all(same_bits(z[k], o) for k, o in
                    zip(("logits", "ids", "sample"), oracle)),
                f"sharded_train: rank {r}'s served shard differs from the "
                f"one-process oracle")
    rel = [float(np.max(np.abs(np.subtract(r["model_sharded"]["losses"],
                                           one["losses"]))
                        / np.abs(one["losses"]))) for r in reports]
    require(max(rel) <= SHARDED_RTOL,
            f"sharded_train: (1, 2) losses off the one-process run by {rel}")
    dp_rel = [float(np.max(np.abs(np.subtract(
        r["data_parallel"]["losses"], one["losses"][:DP_STEPS]))
        / np.abs(one["losses"][:DP_STEPS]))) for r in reports]
    require(max(dp_rel) <= SHARDED_RTOL,
            f"sharded_train: (2, 1) losses off the one-process run by "
            f"{dp_rel}")
    for r in reports:
        ms = r["model_sharded"]
        frac = ms["state_bytes"] / one["state_bytes"]
        require(0.45 < frac < 0.55,
                f"sharded_train rank {r['rank']}: {frac:.3f} of the state")
        require(set(ms["collectives"]) == {"all_reduce"},
                f"sharded_train rank {r['rank']}: a (1, 2) step ran "
                f"{ms['collectives']}: only all-reduces of activations, "
                f"batch-sized values and scalars are expected")
        require(r["served"]["lss_topk_launches"] > 0,
                f"sharded_train rank {r['rank']}: lss_topk not launched")
        ms["state_fraction"] = frac

    launcher = sharded_launch_runs()
    emit({"phase": "sharded_train", "model": cfg.name,
          "input_dim": cfg.input_dim, "hidden": cfg.hidden,
          "output_dim": cfg.output_dim, "steps": SHARDED_STEPS,
          "batch": BATCH, "mesh": "1x2 and 2x1, two processes on one card "
          "over gloo", "one_process": one, "reports": reports,
          "loss_max_rel_diff_1x2": rel, "loss_max_rel_diff_2x1": dp_rel,
          "served": "bit-identical to the one-process 2-shard oracle",
          "fleet_s": fleet_s, "launcher": launcher,
          "seconds": time.perf_counter() - t_phase, "device": smi})
    return {str(r["rank"]): r["served"]["lss_topk_launches"]
            for r in reports}


def fit_line(out):
    """The train launcher's fit seconds and checkpoint saves."""
    return grab(r"fit: (.*)", out, "fit").group(1)


def sharded_launch_runs():
    """``repro_torch.launch.train`` at Qwen2-0.5B width on one directory:
    ``--devices 2 --mesh 1x2`` to step ``LAUNCH_TRAIN_STEPS``,
    ``--devices 2 --mesh 2x1`` resuming to step ``SHARDED_LAUNCH_STEPS``,
    one device resuming with nothing left; seconds and losses."""
    first = LAUNCH_TRAIN_STEPS
    runs = {}
    with tempfile.TemporaryDirectory(prefix="sharded_launch_") as tmp:
        base = ["--arch", "qwen2-0.5b", "--batch", str(SHARDED_LAUNCH_BATCH),
                "--ckpt-dir", tmp]
        out, s = run_launcher(
            "repro_torch.launch.train",
            base + ["--steps", str(first), "--devices", "2", "--mesh",
                    "1x2"], 900)
        require("mesh: 1x2 (data x model) over 2 ranks, backend gloo" in out,
                f"sharded launch 1x2: no mesh line\n{out[-2000:]}")
        runs["1x2"] = {"seconds": s, "fit": fit_line(out), "loss": float(
            grab(rf"done: step {first} loss ([\d.]+)", out,
                 "1x2 train").group(1))}
        n = SHARDED_LAUNCH_STEPS
        out, s = run_launcher(
            "repro_torch.launch.train",
            base + ["--steps", str(n), "--devices", "2", "--mesh", "2x1"],
            900)
        require(f"[trainer] resumed from step {first}" in out
                and "mesh: 2x1 (data x model)" in out,
                f"sharded launch 2x1: did not resume\n{out[-2000:]}")
        runs["2x1"] = {"seconds": s, "resumed_from": first,
                       "fit": fit_line(out),
                       "loss": float(grab(rf"done: step {n} loss ([\d.]+)",
                                          out, "2x1 train").group(1))}
        out, s = run_launcher("repro_torch.launch.train",
                              base + ["--steps", str(n)], 900)
        require(f"resumed at step {n}: nothing left to train" in out,
                f"sharded launch one device: did not resume\n{out[-2000:]}")
        runs["one_device"] = {"seconds": s, "resumed_from": n,
                              "fit": fit_line(out)}
    runs["batch"], runs["seq"] = SHARDED_LAUNCH_BATCH, 128
    return runs


def fleet_launcher_lines(out, what):
    launches = ast.literal_eval(grab(r"kernel launches: (\{.*\})", out,
                                     f"{what} kernel launches").group(1))
    backend = grab(r"multihost: process \d/2 \((?:leader|follower)\), 2 "
                   r"vocab shards, 2 hosts x 1, backend (\w+) on (\S+)",
                   out, f"{what} multihost").groups()
    return launches, backend


def phase_fleet_launch(smi):
    """The serve launcher as a user runs it, as a fleet of two processes
    on the one card (``--head lss-sharded --coordinator --num-processes 2
    --process-id i``) at Qwen2-0.5B full width with 20 training steps:
    ``--mode generate`` (16 prompts x 32 tokens, mirrored), then
    ``--runtime async`` with the index refreshed every second on the
    leader; every prompt and request served, a swap and no refresher
    failure, each process's kernels launched; and ``--mode decode`` with
    the fleet flags, which both processes refuse before the process
    group starts.  Returns each run's kernel launches by rank."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()

    def fleet(extra, timeout=FLEET_LAUNCH_TIMEOUT_S):
        port = free_port()
        t0 = time.perf_counter()
        rcs, outs = run_fleet(
            [[sys.executable, "-m", "repro_torch.launch.serve", "--arch",
              "qwen2-0.5b", "--train-steps", str(LAUNCH_TRAIN_STEPS),
              "--head", "lss-sharded",
              *extra, "--coordinator", f"127.0.0.1:{port}",
              "--num-processes", "2", "--process-id", str(i)]
             for i in range(2)], timeout, "fleet_launch")
        return rcs, outs, time.perf_counter() - t0

    runs, launches = {}, {}
    rcs, (lead, follow), secs = fleet([])
    require(rcs == [0, 0], f"fleet_launch generate: exit codes {rcs}:\n"
            f"{lead[-3000:]}\n{follow[-3000:]}")
    require("decoded (16, 32) tokens on 2 processes; head=lss-sharded"
            in lead and "follower 1: 1 ops served" in follow,
            "fleet_launch generate: prompts not served")
    launches["generate"] = {}
    for rank, out in enumerate((lead, follow)):
        n, backend = fleet_launcher_lines(out, "generate")
        require(backend[0] == "gloo" and n["lss_topk_cuda"] > 0
                and n["simhash_codes_cuda"] > 0,
                f"fleet_launch generate rank {rank}: {backend} {n}")
        launches["generate"][rank] = n
    runs["generate"] = {"seconds": secs, "backend": backend,
                        "launches": launches["generate"]}

    rcs, (lead, follow), secs = fleet(
        ["--runtime", "async", "--qps", str(FLEET_QPS),
         "--refresh-interval", "1"])
    require(rcs == [0, 0], f"fleet_launch async: exit codes {rcs}:\n"
            f"{lead[-3000:]}\n{follow[-3000:]}")
    refresh, _, _ = launcher_counts(lead)
    lat = grab(r"p50=([\d.]+) p95=([\d.]+) p99=([\d.]+) ms \(incl", lead,
               "latency").groups()
    ops = int(grab(r"follower 1: (\d+) ops served", follow, "ops").group(1))
    require("512/512 served" in lead, "fleet_launch async: requests lost")
    require(refresh["failures"] == 0 and refresh["swaps"] >= 1,
            f"fleet_launch async: refresher {refresh}")
    require("index refresh" not in follow,
            "fleet_launch async: a follower refreshed")
    launches["async"] = {}
    for rank, out in enumerate((lead, follow)):
        n, _ = fleet_launcher_lines(out, "async")
        require(n["lss_topk_cuda"] > 0 and n["simhash_codes_cuda"] > 0,
                f"fleet_launch async rank {rank}: {n}")
        launches["async"][rank] = n
    runs["async"] = {"seconds": secs, "refresh": refresh,
                     "follower_ops": ops,
                     "latency_ms": dict(zip(("p50", "p95", "p99"),
                                            map(float, lat))),
                     "launches": launches["async"]}

    rcs, outs, secs = fleet(["--mode", "decode"], timeout=120)
    require(all(rc not in (0, None) for rc in rcs)
            and all("--mode decode is not supported with multi-process"
                    in o and "multihost:" not in o for o in outs),
            f"fleet_launch decode: not refused before the group: {rcs}")
    runs["decode_refused"] = {"exit_codes": rcs, "seconds": secs}
    emit({"phase": "fleet_launch", **runs, "qps": FLEET_QPS,
          "seconds": time.perf_counter() - t_phase, "device": smi})
    return launches


# ------------------------------------------------------ streaming decode --

def decode_prompts(vocab):
    """``DECODE_PROMPTS`` prompts of 100-500 tokens (``lm_dataset``, seed
    ``SEED + 1``): prompts 12-15 repeat prompts 0-3 (a paged join maps
    them from cached pages and skips prefill), prompts 8-11 share their
    first 256 tokens with prompts 4-7 (two cached full pages each)."""
    rows = lm_dataset(SEED + 1, DECODE_PROMPTS * 512, vocab, 512)
    lens = np.random.default_rng(SEED).integers(100, 501, DECODE_PROMPTS)
    prompts = [rows[i, :lens[i]] for i in range(DECODE_PROMPTS)]
    for i in range(4):
        prompts[4 + i] = rows[4 + i, :max(lens[4 + i], 300)]
        prompts[8 + i] = np.concatenate(
            [rows[4 + i, :256], rows[8 + i, 256:max(lens[8 + i], 300)]])
        prompts[12 + i] = prompts[i].copy()
    return prompts


def decode_bounds(dec, lengths_mean):
    """Byte bounds of one decode step over ``DECODE_STREAMS`` rows: the
    layer weights, the valid KV of rows at ``lengths_mean``, and the head
    (full: the fp32 ``[V, d]`` head; LSS: one slab a row, its ids and
    occupied rows at most)."""
    cfg, t = dec.cfg, dec.index.tables
    body = sum(a.numel() * a.element_size()
               for a in tree_leaves(dec.params["layers"]))
    kv_token = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
    kv = DECODE_STREAMS * lengths_mean * kv_token
    full = dec.engine.w.numel() * 4
    d_aug = cfg.d_model + 1
    lss = DECODE_STREAMS * t.n_tables * t.capacity * (4 * d_aug + 4)
    ms = {k: nbytes / PEAK_BYTES_PER_S * 1e3 for k, nbytes in
          (("body", body + kv), ("full", full), ("lss", lss))}
    return {"body_bytes": body, "kv_bytes_per_token": kv_token,
            "kv_bytes": kv, "full_head_bytes": full,
            "lss_head_bytes": lss, "full_ms": ms["body"] + ms["full"],
            "lss_ms": ms["body"] + ms["lss"], "body_ms": ms["body"]}


def run_sessions(sched, prompts, steps):
    streams = [sched.submit(p, max_new_tokens=steps) for p in prompts]
    sched.run(timeout=600.0)
    return [s.result(timeout=60.0) for s in streams]


def decode_runtime(dec, head, prompts, qps):
    """The prompts through a fresh AsyncRuntime's decode kind: paced at
    ``qps`` sessions a second (0: a burst).  Returns the tokens and the
    runtime's stats."""
    sched = dec.scheduler(head=head)
    sched.reset_stats()
    rt = AsyncRuntime(dec.engine, head=head, max_queue=4 * len(prompts),
                      policy="block", scheduler=sched)
    streams, _ = submit_decode_open_loop(rt, prompts, qps, seed=SEED,
                                         max_new_tokens=DECODE_NEW)
    rt.drain(timeout=600.0)
    toks = [s.result(timeout=60.0) for s in streams]
    stats = rt.stats()
    rt.close(timeout=60.0)
    return toks, stats


def check_decode_step(dec, head, prompts, blocking, counters, smi,
                      new_tokens=DECODE_NEW):
    """Outside the counts, on ``DECODE_STREAMS`` sessions mid-flight: one
    replayed step against the eager step on copies of its inputs (the
    same bits; an MoE step's routing counts too, which must come to
    rows x top_k a layer), its head against ``lss_forward`` (the same
    bits) or an
    fp32 GEMM (within ``DECODE_FULL_TOL``, ids exact away from ties),
    host ms of a replay and of an eager step; then the sessions run to
    their end and must give their blocking tokens."""
    sched = dec.scheduler(head=head)
    step_rows = prompts[:DECODE_STREAMS]
    streams = [sched.submit(p, max_new_tokens=new_tokens) for p in step_rows]
    with uncounted(counters):
        for _ in range(3):
            sched.tick()
        step = sched.decode_step()
        ops = sched.pool.step_operands()
        lengths = ops[-1].copy()
        snap = [sched.tok.clone(), ops[0].clone(), ops[1].clone(),
                *(torch.from_numpy(o).to(dec.device) for o in ops[2:])]
        sched.tick()
        hidden, ho, *routing = sched._inflight.out
        want_hidden, want, *want_routing = step.fn(dec.params, *snap)
        torch.cuda.synchronize()
        require(same_tensor_bits(hidden, want_hidden)
                and same_tensor_bits(ho.ids, want.ids)
                and same_tensor_bits(ho.logits, want.logits)
                and len(routing) == len(want_routing)
                and all(same_tensor_bits(a, b)
                        for a, b in zip(routing, want_routing)),
                f"decode {head}: the replay differs from the eager step")
        del snap
        routing_check = {}
        require(bool(routing) == (dec.cfg.moe_style != "none"),
                f"decode {head}: routing counts iff the model has experts")
        if routing:
            # an MoE step routes every pool row, parked ones too, to
            # top_k distinct experts in each layer
            counts = routing[0].cpu().numpy()
            rows = int(sched.tok.shape[0])
            require(counts.shape == (dec.cfg.n_layers,
                                     dec.cfg.n_experts_padded)
                    and (counts.sum(1) == rows * dec.cfg.moe_top_k).all()
                    and not counts[:, dec.cfg.n_experts:].any(),
                    f"decode {head}: routing counts {counts.sum(1)} are not "
                    f"{rows} rows x top {dec.cfg.moe_top_k} a layer")
            routing_check = {"routing_counts": "bit-identical",
                             "routed_a_layer": rows * dec.cfg.moe_top_k,
                             "experts_hit": int((counts > 0).sum())}
        q = hidden.float()
        if head == "lss":
            ref = lss_forward(q, dec.engine.index_for(sched._epoch), None, 1)
            require(same_tensor_bits(ho.ids, ref.top_ids)
                    and same_tensor_bits(ho.logits, ref.top_logits),
                    "decode lss: the step differs from lss_forward")
            head_check = {"vs_lss_forward": "bit-identical"}
        else:
            w = dec.engine.w
            want_lg, want_ids = topk_lowest_index(q @ w.T, 2)
            scale = logit_scale(want_lg[:, :1])
            err = assert_close(ho.logits, want_lg[:, :1],
                               rtol=DECODE_FULL_TOL,
                               atol=DECODE_FULL_TOL * scale,
                               what="decode full-head logits")
            n_ids = assert_topk_ids_equal(
                ho.ids, want_ids[:, :1], want_lg[:, :1],
                DECODE_FULL_TOL * scale, next_logit=want_lg[:, 1],
                what="decode full-head ids")
            head_check = {"vs_fp32_gemm_max_abs_err": err,
                          "ids_checked": n_ids}
        # host ms of one step in this state: a call writes this step's
        # KV at each row's position again (the next real step rewrites
        # it) and feeds its tokens back, so the tokens are put back
        tok0 = sched.tok.clone()
        ops = sched.pool.step_operands()
        dev_ops = [torch.from_numpy(o).to(dec.device) for o in ops[2:]]
        graph_ms = host_ms(lambda: step(dec.params, sched.tok, *ops))
        eager_ms = host_ms(lambda: step.fn(dec.params, sched.tok, ops[0],
                                           ops[1], *dev_ops), iters=5)
        sched.tok.copy_(tok0)
        sched.run(timeout=600.0)
    for i, st in enumerate(streams):
        require(np.array_equal(st.result(timeout=60.0), blocking[i]),
                f"decode {head}: session {i} differs after the checks")
    return {"head": head, "rows": DECODE_STREAMS,
            "mean_length": float(lengths.mean()), "graph_ms": graph_ms,
            "eager_ms": eager_ms, "graph_vs_eager": "bit-identical",
            **head_check, **routing_check, "device": smi}, q


def decode_kernels(index, q, q_calib, smi):
    """``lss_topk`` at the decode step's shapes (``q``: the hidden states
    of ``DECODE_STREAMS`` rows), B = 8 and B = 1, against its plain
    version, timed beside its bound, with its shared-memory layout
    (narrow or wide); and ``simhash_codes`` at ``fit_lss``'s mining batch
    (256 calibration queries ``q_calib`` at the head's d, K and L; whole
    or in d-tiles), the same way."""
    t = index.tables
    q_aug = augment_queries(q.float())
    d = q_aug.shape[1]
    shape = (d, t.k_bits, t.n_tables, t.capacity)
    lay = lss_topk_ops.lss_topk_layout(*shape)
    lib = lss_topk_ops._library()
    require(lay.smem == lib.lss_topk_smem_bytes(*shape, 0)
            and lay.scratch == lib.lss_topk_scratch_bytes(*shape, 0)
            and lay.wide == bool(lib.lss_topk_wide(*shape, 0)),
            "smem, scratch or wide formula drifted")
    out = {"d_aug": d, "K": t.k_bits, "L": t.n_tables, "P": t.capacity,
           "layout": "wide" if lay.wide else "narrow",
           "smem_bytes": lay.smem, "scratch_bytes": lay.scratch,
           "rows_per_chunk": lay.rows,
           "blocks_per_sm": lss_topk_ops.lss_topk_blocks_per_sm(
               d, t.k_bits, t.n_tables, t.capacity), "device": smi}
    for bsz in (DECODE_STREAMS, 1):
        qb = q_aug[:bsz].contiguous()
        args = (qb, index.theta, t.table_ids, index.w_bucketed)
        _, check, got = compare_lss_topk(*args, None, 1)
        b_ms, b_by, nbytes, _ = lss_topk_bound_ms(qb, index, got[3], 1)
        out[f"B{bsz}"] = {
            "ms": time_ms(lambda: lss_topk(*args, top_k=1)),
            "plain_ms": time_ms(lambda: lss_topk_ref(*args, top_k=1),
                                iters=5),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
            **check}
    code_args = (unit(augment_queries(q_calib[:256].float())), index.theta,
                 t.k_bits, t.n_tables)
    _, s_err = compare_simhash(*code_args)
    s_b, s_by, _, _ = simhash_bound_ms(256, d, t.k_bits, t.n_tables)
    return {"lss_topk": out, "simhash_codes": {
        "B": 256, "d_aug": d, "K": t.k_bits, "L": t.n_tables,
        "d_tile": simhash_codes_plan(256, d, t.k_bits, t.n_tables,
                                     _build.sm_count(q.device)).tile,
        "max_abs_err": s_err, "ms": time_ms(lambda: simhash_codes(*code_args)),
        "plain_ms": time_ms(lambda: simhash_codes_ref(*code_args)),
        "bound_ms": s_b, "bound_by": s_by, "device": smi}}


def phase_decode(dev, smi, counters):
    """Streaming decode at Qwen2-0.5B's full width (random bf16 weights,
    seed 0): ``LMDecoder.fit_lss`` on the 151,936-wide LM head (K = 10,
    L = 1, P = 304), then ``DECODE_PROMPTS`` prompts of 100-500 tokens,
    ``DECODE_NEW`` new tokens each: blocking ``generate`` one prompt at a
    time (dense KV) with both heads; the same sessions interleaved
    through the paged KV layout (prefix-shared prompts skip prefill); the
    AsyncRuntime's decode kind at ``DECODE_QPS`` sessions a second and in
    a burst (LSS), in a burst (full).  Every run gives the blocking
    tokens bit for bit.  That is the counted run (``simhash_codes`` in
    ``fit_lss``; ``lss_topk`` in each LSS step's warm-up and capture;
    ``decode_attention`` once a layer in each decode step's warm-up and
    capture), and the paged LSS run inside it runs under
    ``torch.profiler``, which must see one ``lss_topk`` kernel for each
    step replayed, each first-token rank and each warm-up, and the two
    ``decode_attn`` kernels once a layer for each step replayed and each
    warm-up.
    Then, outside the counts: a replayed step against the eager step,
    ``lss_forward`` and an fp32 GEMM; ``lss_topk`` at the decode shapes against its plain version; ms a
    step beside the byte bounds."""
    t_phase = time.perf_counter()
    cfg = qwen2_0_5b.CONFIG.model_cfg
    lss_cfg = qwen2_0_5b.CONFIG.lss._replace(iul_epochs=DECODE_IUL_EPOCHS)
    params = T.init_params(torch.Generator(dev).manual_seed(SEED), cfg,
                           device=dev)
    calib = lm_dataset(SEED, DECODE_CALIB[0] * DECODE_CALIB[1], cfg.vocab,
                       DECODE_CALIB[1])
    prompts = decode_prompts(cfg.vocab)
    dense = LMDecoder(params, cfg, lss_cfg, max_streams=DECODE_STREAMS,
                      max_len=DECODE_MAX_LEN, kv_layout="dense")
    torch.cuda.synchronize()

    reset(counters)
    t0 = time.perf_counter()
    hist = dense.fit_lss(torch.Generator(dev).manual_seed(SEED + 1), calib)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    index = dense.index
    t = index.tables
    emit({"phase": "decode_fit", "model": cfg.name, "vocab": cfg.vocab,
          "d_model": cfg.d_model, "layers": cfg.n_layers,
          "calib_positions": calib.shape[0] * (calib.shape[1] - 1),
          "iul_epochs": lss_cfg.iul_epochs, "seconds": fit_s,
          "K": t.k_bits, "L": t.n_tables, "P": t.capacity,
          "C": t.n_tables * t.capacity,
          "n_dropped": int(t.n_dropped.sum()),
          "calib_recall": hist["recall"], "device": smi})
    require((t.k_bits, t.n_tables, t.capacity) == (10, 1, 304),
            f"decode: index K, L, P = {t.k_bits}, {t.n_tables}, "
            f"{t.capacity}, not 10, 1, 304")

    # blocking: one generate a prompt, the dense pool
    blocking, seconds, steps = {}, {}, {}
    for head in ("full", "lss"):
        t0 = time.perf_counter()
        blocking[head] = [
            dense.generate(p[None], steps=DECODE_NEW, head=head,
                           timeout=600.0).numpy()[0] for p in prompts]
        seconds[f"blocking_{head}"] = time.perf_counter() - t0
        steps[f"blocking_{head}"] = dense.scheduler(head).stats().n_steps
    for head in ("full", "lss"):
        toks = np.stack(blocking[head])
        require(toks.shape == (DECODE_PROMPTS, DECODE_NEW)
                and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
                f"decode {head}: tokens out of range")

    # the same sessions interleaved through the paged pool; the LSS run
    # under torch.profiler, which counts the lss_topk kernels it ran
    from torch.profiler import ProfilerActivity, profile
    paged = LMDecoder(params, cfg, lss_cfg, max_streams=DECODE_STREAMS,
                      max_len=DECODE_MAX_LEN, kv_layout="paged")
    paged.engine._set_index(index)
    paged_stats = {}
    for head in ("full", "lss"):
        sched = paged.scheduler(head=head)
        attn_builds0 = decode_builds(paged)
        t0 = time.perf_counter()
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if head == "lss" else contextlib.nullcontext()) as prof:
            toks = run_sessions(sched, prompts, DECODE_NEW)
            torch.cuda.synchronize()
        seconds[f"paged_{head}"] = time.perf_counter() - t0
        paged_stats[head] = sched.stats()._asdict()
        require(all(np.array_equal(a, b)
                    for a, b in zip(toks, blocking[head])),
                f"decode {head}: paged tokens differ from dense")
        require(paged_stats[head]["n_prefill_skipped"] > 0,
                f"decode {head}: no prefill skipped in the paged run")
    # one lss_topk kernel on the device a replayed decode step or
    # first-token rank, and one a warm-up of each LSS step built here
    s = paged_stats["lss"]
    device_launches = device_kernel_count(prof, "lss_topk")
    attn_kernels = device_kernel_count(prof, "decode_attn")
    window_breakdown(prof, "decode_paged_lss", smi)
    del prof
    ranked = s["n_sessions"] - s["n_prefill_skipped"]
    builds = sum(n for (kind, _), n in paged.engine.compile_counts.items()
                 if kind == "lss")
    require(device_launches == s["n_steps"] + ranked + builds,
            f"decode: the profiler saw {device_launches} lss_topk kernels "
            f"in the paged LSS run for {s['n_steps']} steps, {ranked} "
            f"first-token ranks and {builds} warm-ups")
    attn_warm_ups = decode_builds(paged) - attn_builds0
    require(attn_kernels == 2 * cfg.n_layers * (s["n_steps"]
                                                + attn_warm_ups),
            f"decode: the profiler saw {attn_kernels} decode_attn kernels "
            f"in the paged LSS run for {s['n_steps']} steps and "
            f"{attn_warm_ups} warm-ups of {cfg.n_layers} layers")
    profiled = {"run": "paged_lss", "lss_topk_kernels": device_launches,
                "decode_attn_kernels": attn_kernels,
                "steps": s["n_steps"], "first_token_ranks": ranked,
                "warm_ups": builds, "decode_step_warm_ups": attn_warm_ups}

    # the runtime's decode kind, interleaved
    runs = {"lss_open_loop": ("lss", DECODE_QPS), "lss_burst": ("lss", 0.0),
            "full_burst": ("full", 0.0)}
    runtime_stats = {}
    for name, (head, qps) in runs.items():
        t0 = time.perf_counter()
        toks, s = decode_runtime(dense, head, prompts, qps)
        seconds[f"runtime_{name}"] = time.perf_counter() - t0
        require(all(np.array_equal(a, b)
                    for a, b in zip(toks, blocking[head])),
                f"decode {name}: interleaved tokens differ from blocking")
        require(s.n_decode_done == DECODE_PROMPTS
                and s.n_decode_tokens == DECODE_PROMPTS * DECODE_NEW
                and s.n_shed_queue == 0 and s.n_shed_deadline == 0,
                f"decode {name}: sessions shed or lost")
        runtime_stats[name] = s._asdict()
    launches = read(counters)
    emit({"phase": "decode", "prompts": DECODE_PROMPTS,
          "prompt_lengths": [len(p) for p in prompts],
          "new_tokens": DECODE_NEW, "streams": DECODE_STREAMS,
          "max_len": DECODE_MAX_LEN, "seconds": seconds,
          "blocking_steps": steps, "launches": launches,
          "profiler": profiled,
          "tokens": "paged = dense, interleaved = blocking, bit for bit, "
                    "both heads",
          "top1_agreement_lss_vs_full": float(np.mean(
              np.stack(blocking["lss"]) == np.stack(blocking["full"]))),
          "paged": paged_stats, "runtime": runtime_stats,
          "compile_counts": {f"{k}:{b}": v for (k, b), v in
                             dense.engine.compile_counts.items()},
          "device": smi})
    require(launches["simhash_codes_cuda"] > 0,
            "decode: simhash_codes was not launched in fit_lss")
    require(launches["lss_topk_cuda"] == 8,
            f"decode: lss_topk wrapper launches {launches['lss_topk_cuda']},"
            f" not a warm-up and a capture for each of 4 LSS steps (the "
            f"decode step and the first-token step of each layout)")
    require(launches["bucket_logits_cuda"] == 0,
            "decode: bucket_logits was launched")
    check_prefills(launches, cfg.n_layers, "decode")
    attn_builds = decode_builds(dense) + decode_builds(paged)
    require(launches["decode_attention_cuda"]
            == 2 * cfg.n_layers * attn_builds,
            f"decode: decode_attention wrapper launches "
            f"{launches['decode_attention_cuda']}, not one a layer in the "
            f"warm-up and the capture of each of {attn_builds} decode steps")
    torch.cuda.synchronize()
    mem = {"allocated_mb": torch.cuda.memory_allocated() / 2 ** 20,
           "reserved_mb": torch.cuda.memory_reserved() / 2 ** 20,
           "kv_dense_bytes": dense.scheduler("lss").pool.storage_bytes(),
           "kv_paged_bytes": paged.scheduler("lss").pool.storage_bytes()}
    del paged

    checks, hidden = zip(*(check_decode_step(dense, head, prompts,
                                             blocking[head], counters, smi)
                           for head in ("lss", "full")))

    with uncounted(counters):
        kernels = decode_kernels(index, hidden[0], dense.engine.calib[0],
                                 smi)
    bounds = decode_bounds(dense, float(np.mean(
        [c["mean_length"] for c in checks])))
    emit({"phase": "decode_timing",
          "what": "host-clock ms of one fused step over 8 rows, "
                  "synchronised (median of 20 replays, 5 eager runs), "
                  "beside the byte bounds at 3.35 TB/s",
          "steps": checks, "bounds": bounds, **kernels, "memory": mem, "seconds": time.perf_counter() - t_phase,
          "device": smi})
    return launches, {"lss_topk": device_launches,
                      "decode_attn": attn_kernels}, {
        "dense": dense, "params": params, "prompts": prompts,
        "blocking": blocking, "hidden": hidden[0]}


# ------------------------------------------------------------ model zoo --

def lss_builds(dec):
    """LSS steps the decoder's engine has built (warm-up + capture each)."""
    return sum(n for (kind, _), n in dec.engine.compile_counts.items()
               if kind == "lss")


def decode_builds(dec):
    """Fused decode steps the decoder's engine has built, of either head
    (warm-up + capture each; each runs ``decode_attention`` once a
    layer)."""
    return sum(n for (_, tag), n in dec.engine.compile_counts.items()
               if isinstance(tag, str) and tag.startswith("decode["))


def param_bytes(params):
    return sum(a.numel() * a.element_size() for a in tree_leaves(params))


def zoo_lm_decode(dev, smi, counters, spec, cfg, prompts, new_tokens,
                  what):
    """An LM of the zoo at full width (random bf16 weights, seed 0):
    ``LMDecoder.fit_lss`` on its head (``simhash_codes``; the arch's K and
    L, ``DECODE_CALIB`` positions), ``prompts`` through blocking
    ``generate`` one at a time (dense KV) with both heads, then the same
    sessions interleaved on the same pool, whose tokens must equal the
    blocking ones bit for bit; the interleaved LSS run under
    ``torch.profiler``, which must see one ``lss_topk`` kernel a replayed
    step and a first-token rank, and the two ``decode_attn`` kernels once
    a layer a replayed step and a warm-up.  That is the counted run, in
    which ``decode_attention`` runs once a layer in each decode step's
    warm-up and capture.  Returns the decoder, its blocking tokens, the
    wrappers' launches and the profiler's kernel counts."""
    lss_cfg = spec.lss._replace(iul_epochs=DECODE_IUL_EPOCHS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(dev).manual_seed(SEED), cfg,
                           device=dev)
    torch.cuda.synchronize()
    setup = {"init_seconds": time.perf_counter() - t0,
             "param_bytes": param_bytes(params),
             "expert_bytes": param_bytes(params["layers"].get("moe", {})),
             "allocated_mb": torch.cuda.memory_allocated() / 2 ** 20}
    calib = lm_dataset(SEED, DECODE_CALIB[0] * DECODE_CALIB[1], cfg.vocab,
                       DECODE_CALIB[1])
    dense = LMDecoder(params, cfg, lss_cfg, max_streams=DECODE_STREAMS,
                      max_len=DECODE_MAX_LEN, kv_layout="dense")
    del params

    reset(counters)
    t0 = time.perf_counter()
    hist = dense.fit_lss(torch.Generator(dev).manual_seed(SEED + 1), calib)
    torch.cuda.synchronize()
    seconds = {"fit_lss": time.perf_counter() - t0}
    t = dense.index.tables
    want = (spec.lss.k_bits, spec.lss.n_tables,
            spec.lss.resolve_capacity(cfg.vocab))
    require((t.k_bits, t.n_tables, t.capacity) == want,
            f"{what}: index K, L, P = {t.k_bits}, {t.n_tables}, "
            f"{t.capacity}, not {want}")
    blocking = {}
    for head in ("full", "lss"):
        t0 = time.perf_counter()
        blocking[head] = [
            dense.generate(p[None], steps=new_tokens, head=head,
                           timeout=600.0).numpy()[0] for p in prompts]
        seconds[f"blocking_{head}"] = time.perf_counter() - t0
        toks = np.stack(blocking[head])
        require(toks.shape == (len(prompts), new_tokens)
                and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
                f"{what} {head}: tokens out of range")
    from torch.profiler import ProfilerActivity, profile
    inter = {}
    for head in ("full", "lss"):
        sched = dense.scheduler(head=head)
        sched.reset_stats()
        builds0, attn_builds0 = lss_builds(dense), decode_builds(dense)
        t0 = time.perf_counter()
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if head == "lss" else contextlib.nullcontext()) as prof:
            toks = run_sessions(sched, prompts, new_tokens)
            torch.cuda.synchronize()
        seconds[f"interleaved_{head}"] = time.perf_counter() - t0
        inter[head] = sched.stats()._asdict()
        require(all(np.array_equal(a, b)
                    for a, b in zip(toks, blocking[head])),
                f"{what} {head}: interleaved tokens differ from blocking")
    s = inter["lss"]
    device_launches = device_kernel_count(prof, "lss_topk")
    attn_kernels = device_kernel_count(prof, "decode_attn")
    window_breakdown(prof, f"{what}_interleaved_lss", smi)
    del prof
    ranked = s["n_sessions"] - s["n_prefill_skipped"]
    builds = lss_builds(dense) - builds0
    attn_warm_ups = decode_builds(dense) - attn_builds0
    require(device_launches == s["n_steps"] + ranked + builds,
            f"{what}: the profiler saw {device_launches} lss_topk kernels "
            f"in the interleaved LSS run for {s['n_steps']} steps, {ranked} "
            f"first-token ranks and {builds} warm-ups")
    require(attn_kernels == 2 * cfg.n_layers * (s["n_steps"]
                                                + attn_warm_ups),
            f"{what}: the profiler saw {attn_kernels} decode_attn kernels "
            f"in the interleaved LSS run for {s['n_steps']} steps and "
            f"{attn_warm_ups} warm-ups of {cfg.n_layers} layers")
    launches = read(counters)
    attn_builds = decode_builds(dense)
    require(launches["decode_attention_cuda"]
            == 2 * cfg.n_layers * attn_builds,
            f"{what}: decode_attention wrapper launches "
            f"{launches['decode_attention_cuda']}, not one a layer in the "
            f"warm-up and the capture of each of {attn_builds} decode steps")
    require(launches["simhash_codes_cuda"] > 0,
            f"{what}: simhash_codes was not launched in fit_lss")
    require(launches["lss_topk_cuda"] > 0,
            f"{what}: lss_topk was not launched")
    require(launches["bucket_logits_cuda"] == 0,
            f"{what}: bucket_logits was launched")
    check_prefills(launches, cfg.n_layers, what)
    emit({"phase": what, "model": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab,
          "experts": cfg.n_experts_padded, "top_k": cfg.moe_top_k,
          "moe_style": cfg.moe_style, **setup,
          "K": t.k_bits, "L": t.n_tables, "P": t.capacity,
          "n_dropped": int(t.n_dropped.sum()),
          "calib_recall": hist["recall"], "prompts": len(prompts),
          "prompt_lengths": [len(p) for p in prompts],
          "new_tokens": new_tokens, "streams": DECODE_STREAMS,
          "seconds": seconds, "launches": launches,
          "profiler": {"lss_topk_kernels": device_launches,
                       "decode_attn_kernels": attn_kernels,
                       "steps": s["n_steps"], "first_token_ranks": ranked,
                       "warm_ups": builds,
                       "decode_step_warm_ups": attn_warm_ups},
          "tokens": "interleaved = blocking, bit for bit, both heads",
          "top1_agreement_lss_vs_full": float(np.mean(
              np.stack(blocking["lss"]) == np.stack(blocking["full"]))),
          "interleaved": inter, "device": smi})
    return dense, blocking, launches, {"lss_topk": device_launches,
                                       "decode_attn": attn_kernels}


def zoo_decode_timing(dense, prompts, blocking, counters, smi, new_tokens,
                      heads, what, t_phase):
    """Outside the counts: the replayed step against the eager step and
    its head against ``lss_forward`` / an fp32 GEMM (check_decode_step),
    ms a step beside the byte bounds, ``lss_topk`` and ``simhash_codes``
    at the head's width against their plain versions (decode_kernels),
    and the peak memory of the phase."""
    checks, hidden = zip(*(check_decode_step(dense, head, prompts,
                                             blocking[head], counters, smi,
                                             new_tokens=new_tokens)
                           for head in heads))
    with uncounted(counters):
        kernels = decode_kernels(dense.index, hidden[0],
                                 dense.engine.calib[0], smi)
    bounds = decode_bounds(dense, float(np.mean(
        [c["mean_length"] for c in checks])))
    emit({"phase": f"{what}_timing",
          "what": "host-clock ms of one fused step over 8 rows, "
                  "synchronised (median of 20 replays, 5 eager runs), "
                  "beside the byte bounds at 3.35 TB/s (every padded "
                  "expert's weights are read each step)",
          "steps": checks, "bounds": bounds, **kernels,
          "peak_allocated_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
          **mem_mb(), "seconds": time.perf_counter() - t_phase,
          "device": smi})
    return kernels


def phase_moe_decode(dev, smi, counters):
    """qwen2-moe-a2.7b at full width and depth (24 layers, d_model 2,048,
    64 padded experts top-4 + the shared expert, random bf16 weights):
    the counted run of :func:`zoo_lm_decode` on prompts 4-11 of
    ``decode_prompts`` (8 x ``MOE_NEW`` tokens), the 151,936-wide head
    served by ``lss_topk`` (K = 10, L = 1, P = 304).  At 8 slots no expert
    gets more tokens than its capacity max(8, ...), so decode drops
    nothing and interleaving cannot change a token.  Then, outside the
    counts: the same prompts through the paged pool, where prompts 8-11
    share two cached pages with 4-7 and prefill only their suffix (a
    prefill drops tokens by the prompt's own length, so that run may
    differ: its agreement is reported, not required), and the timings."""
    t_phase = time.perf_counter()
    spec = qwen2_moe_a2_7b.CONFIG
    cfg = spec.model_cfg
    prompts = decode_prompts(cfg.vocab)[4:4 + MOE_PROMPTS]
    dense, blocking, launches, device_launches = zoo_lm_decode(
        dev, smi, counters, spec, cfg, prompts, MOE_NEW, "moe_decode")
    require((cfg.n_layers, cfg.d_model) == (24, 2048),
            "moe_decode: not qwen2-moe-a2.7b's full width and depth")
    with uncounted(counters):
        paged = LMDecoder(dense.params, cfg, dense.lss_cfg,
                          max_streams=DECODE_STREAMS, max_len=DECODE_MAX_LEN,
                          kv_layout="paged")
        paged.engine._set_index(dense.index)
        sched = paged.scheduler(head="lss")
        t0 = time.perf_counter()
        toks = run_sessions(sched, prompts, MOE_NEW)
        torch.cuda.synchronize()
        ps = sched.stats()
        del sched, paged
        gc.collect()
    same = [np.array_equal(a, b) for a, b in zip(toks, blocking["lss"])]
    emit({"phase": "moe_decode_paged", "seconds": time.perf_counter() - t0,
          "prefill_skipped": ps.n_prefill_skipped,
          "prefix_hit_rate": ps.prefix_hit_rate,
          "sessions_equal_to_blocking": int(sum(same)),
          "sessions": len(same),
          "token_agreement": float(np.mean(
              np.stack(toks) == np.stack(blocking["lss"]))),
          "note": "suffix-only prefill routes a different token set "
                  "through capacity-limited experts; reported, not "
                  "required", "device": smi})
    kernels = zoo_decode_timing(dense, prompts, blocking, counters, smi,
                                MOE_NEW, ("lss", "full"), "moe_decode",
                                t_phase)
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "device": device_launches,
            "kernels": kernels}


def phase_arctic_decode(dev, smi, counters):
    """arctic-480b at full width (d_model 7,168, 128 experts top-2 with
    the dense residual MLP in parallel, vocab 32,000) cut to
    ``ARCTIC_LAYERS`` layer (one layer is 27.2 GB in bf16; 35 do not fit
    one card): the counted run of :func:`zoo_lm_decode` (``fit_lss`` at
    K = 8 through the tiled ``simhash_codes``, ``ARCTIC_PROMPTS``
    interleaved sessions through the wide ``lss_topk``), then
    ``lss_topk`` and ``simhash_codes`` against their plain versions at
    d = 7,169."""
    t_phase = time.perf_counter()
    spec = arctic_480b.CONFIG
    cfg = spec.model_cfg._replace(n_layers=ARCTIC_LAYERS)
    prompts = decode_prompts(cfg.vocab)[:ARCTIC_PROMPTS]
    dense, blocking, launches, device_launches = zoo_lm_decode(
        dev, smi, counters, spec, cfg, prompts, ARCTIC_NEW, "arctic_decode")
    kernels = zoo_decode_timing(dense, prompts, blocking, counters, smi,
                                ARCTIC_NEW, ("lss",), "arctic_decode",
                                t_phase)
    require(kernels["lss_topk"]["layout"] == "wide"
            and kernels["simhash_codes"]["d_tile"] > 0,
            "arctic_decode: the kernels did not take their wide layouts")
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "device": device_launches,
            "kernels": kernels, "cut": {"n_layers": (35, ARCTIC_LAYERS)}}


def phase_bert4rec_serve(dev, smi, counters):
    """BERT4Rec at its full config (1,000,000 items, d = 64, 2 blocks,
    seq_len 200; random weights, seed 0) at serve_p99's batch of 512:
    ``bert4rec_encode``, the last position's hidden, then the LSS top-10
    through ``lss_topk`` (``lss_forward``) over an index of the augmented
    item head (K = 12, L = 1, P = 496, random hyperplanes): the one-shard
    case of the JAX package's serve cell.  The counted run is that path;
    then ``lss_topk`` against its plain version on the same queries, the
    exact full-head top-10 recall (reported), and timings."""
    t_phase = time.perf_counter()
    spec = bert4rec.CONFIG
    cfg = spec.model_cfg
    gen = torch.Generator(dev).manual_seed(SEED)
    params = recsys.init_bert4rec(gen, cfg, device=dev)
    w_aug = augment_neurons(params["head"])
    theta = init_hyperplanes(gen, cfg.embed_dim + 1, spec.lss.k_bits,
                             spec.lss.n_tables, device=dev)
    index = build_index(w_aug, theta, spec.lss)
    t = index.tables
    require((t.k_bits, t.n_tables, t.capacity) == (12, 1, 496),
            f"bert4rec_serve: index K, L, P = {t.k_bits}, {t.n_tables}, "
            f"{t.capacity}, not 12, 1, 496")
    seq = torch.from_numpy(seqrec_dataset(SEED, ZOO_BATCH, cfg.seq_len,
                                          cfg.n_items)[0]).to(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase

    def serve():
        hidden = recsys.bert4rec_encode(params, seq, cfg)
        q = hidden[:, -1].float()
        return q, lss_forward(q, index, None, BERT4REC_TOP_K)

    reset(counters)
    t0 = time.perf_counter()
    q, res = serve()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = read(counters)
    require(launches["lss_topk_cuda"] > 0,
            "bert4rec_serve: lss_topk was not launched")
    require(launches["bucket_logits_cuda"] == 0,
            "bert4rec_serve: bucket_logits was launched")
    ids = res.top_ids
    require(tuple(ids.shape) == (ZOO_BATCH, BERT4REC_TOP_K)
            and bool(((ids >= -1) & (ids < cfg.n_items)).all())
            and bool(torch.isfinite(q).all()),
            "bert4rec_serve: top ids out of shape or range")
    with uncounted(counters):
        q_aug = augment_queries(q)
        args = (q_aug, index.theta, t.table_ids, index.w_bucketed)
        rows, check, got = compare_lss_topk(*args, index.w_scale,
                                            BERT4REC_TOP_K, chunk=128)
        require(same_tensor_bits(got[1], ids)
                and same_tensor_bits(got[0], res.top_logits),
                "bert4rec_serve: the path's top-10 differs from the "
                "kernel's on the same queries")
        full = recsys.retrieval_scores(params, q)
        exact = torch.topk(full, BERT4REC_TOP_K).indices
        del full
        hit = (ids[:, :, None] == exact[:, None, :]).any(-1).float()
        b_ms, b_by, nbytes, _ = lss_topk_bound_ms(q_aug, index, got[3],
                                                  BERT4REC_TOP_K)
        kernel = {"B": ZOO_BATCH, "d_aug": q_aug.shape[1], "K": t.k_bits,
                  "L": t.n_tables, "P": t.capacity,
                  "layout": "wide" if lss_topk_ops.lss_topk_layout(
                      q_aug.shape[1], t.k_bits, t.n_tables,
                      t.capacity).wide else "narrow",
                  "ms": time_ms(lambda: lss_topk(*args,
                                                 top_k=BERT4REC_TOP_K)),
                  "plain_ms": time_ms(lambda: lss_topk_ref(
                      *args, top_k=BERT4REC_TOP_K), iters=5),
                  "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
                  **check}
        timing = {
            "encode_ms": host_ms(lambda: recsys.bert4rec_encode(
                params, seq, cfg), iters=5),
            "lss_forward_ms": host_ms(lambda: lss_forward(
                q, index, None, BERT4REC_TOP_K)),
            "full_head_topk_ms": host_ms(lambda: torch.topk(
                recsys.retrieval_scores(params, q), BERT4REC_TOP_K),
                iters=5)}
    emit({"phase": "bert4rec_serve", "items": cfg.n_items,
          "d": cfg.embed_dim, "blocks": cfg.n_blocks,
          "seq_len": cfg.seq_len, "batch": ZOO_BATCH,
          "K": t.k_bits, "L": t.n_tables, "P": t.capacity,
          "n_dropped": int(t.n_dropped.sum()),
          "setup_seconds": setup_s, "serve_seconds": serve_s,
          "launches": launches, "margin_rows": int(rows.sum()),
          "mean_sample_size": float(res.sample_size.float().mean()),
          "full_head_top10_recall": float(hit.mean()),
          "lss_topk": kernel, **timing,
          "peak_allocated_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
          "seconds": time.perf_counter() - t_phase, "device": smi})
    del params, index, w_aug
    torch.cuda.empty_cache()
    return {"launches": launches, "kernel": kernel}


def ctr_batch(cfg):
    """serve_p99's 512 rows for a CTR model: ``ctr_dataset``'s zipf ids
    and planted labels (DeepFM, AutoInt), or DIEN's histories (zipf item
    ids, a padded tail of random length) and targets."""
    if cfg.kind != "dien":
        ids, labels = ctr_dataset(SEED, ZOO_BATCH, cfg.n_fields,
                                  cfg.vocab_per_field)
        return {"ids": ids, "labels": labels}
    rng = np.random.default_rng(SEED)
    hist = (rng.zipf(1.2, (ZOO_BATCH, cfg.seq_len)) - 1) % cfg.vocab_per_field
    hist[np.arange(cfg.seq_len)[None] >= rng.integers(
        10, cfg.seq_len + 1, ZOO_BATCH)[:, None]] = -1
    return {"hist": hist.astype(np.int32),
            "target": ((rng.zipf(1.2, ZOO_BATCH) - 1)
                       % cfg.vocab_per_field).astype(np.int32),
            "labels": (rng.random(ZOO_BATCH) < 0.3).astype(np.int32)}


def zoo_step_one(name, params, forward, loss_fn, out_shape, smi):
    """One forward and one loss-and-gradient step: finite, the forward's
    shape, a finite gradient of every parameter's shape; host ms of each
    (synchronised), peak memory."""
    leaves, treedef = tree_flatten(params)
    out = forward(params)
    require(tuple(out.shape) == out_shape and bool(torch.isfinite(out).all()),
            f"zoo_step {name}: forward gave {tuple(out.shape)}, not "
            f"{out_shape}, or a non-finite value")

    def step():
        with torch.enable_grad():
            live = [a.detach().requires_grad_(True) for a in leaves]
            loss = loss_fn(tree_unflatten(treedef, live))
            return loss, torch.autograd.grad(loss, live)

    loss, grads = step()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(loss))
            and all(g.shape == a.shape and bool(torch.isfinite(g).all())
                    for g, a in zip(grads, leaves)),
            f"zoo_step {name}: a non-finite loss or gradient")
    del grads
    return {"model": name, "out_shape": list(out_shape),
            "loss": float(loss), "param_bytes": param_bytes(params),
            "forward_ms": host_ms(lambda: forward(params), iters=5),
            "step_ms": host_ms(step, iters=3), "device": smi}


def phase_zoo_step(dev, smi):
    """DeepFM, AutoInt and DIEN at their full configs (39 x 1M-row tables,
    DIEN's 2M items) at serve_p99's 512 rows, and the GCN at full_graph_sm
    (2,708 nodes, 10,556 edges, 1,433 features: ``graph_dataset``) and at
    molecule (128 graphs of 30 nodes, 64 edges, 32 features, a mean-pool
    readout): one forward and one loss-and-gradient step each (the JAX
    package's losses: its CTR train cells' logistic loss, ``gnn.loss``,
    ``gnn.molecule_loss``), finite, with the reference's shapes."""
    t_phase = time.perf_counter()
    rows = []
    for arch in ("deepfm", "autoint", "dien"):
        cfg = get_arch(arch).model_cfg
        init = {"deepfm": recsys.init_deepfm, "autoint": recsys.init_autoint,
                "dien": recsys.init_dien}[arch]
        torch.cuda.reset_peak_memory_stats()
        params = init(torch.Generator(dev).manual_seed(SEED), cfg,
                      device=dev)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in ctr_batch(cfg).items()}
        rows.append(zoo_step_one(
            arch, params, lambda p: ctr_logits(p, batch, cfg),
            lambda p: ctr_loss(p, batch, cfg), (ZOO_BATCH,), smi))
        rows[-1]["peak_allocated_mb"] = \
            torch.cuda.max_memory_allocated() / 2 ** 20
        del params, batch
    spec = get_arch("gcn-cora")
    sm = spec.shape("full_graph_sm").dims
    cfg = spec.model_cfg._replace(d_feat=sm["d_feat"],
                                  n_classes=sm["n_classes"])
    g = graph_dataset(SEED, sm["n_nodes"], sm["n_edges"], sm["d_feat"],
                      sm["n_classes"])
    batch = {"x": torch.from_numpy(g["x"]).to(dev),
             "edges": torch.from_numpy(g["edges"]).to(dev),
             "labels": torch.from_numpy(g["train_labels"]).to(dev)}
    params = gnn.init_params(torch.Generator(dev).manual_seed(SEED), cfg,
                             device=dev)
    rows.append(zoo_step_one(
        "gcn-cora/full_graph_sm", params,
        lambda p: gnn.forward(p, batch["x"], batch["edges"], cfg),
        lambda p: gnn.loss(p, batch, cfg),
        (sm["n_nodes"], sm["n_classes"]), smi))
    mol = spec.shape("molecule").dims
    cfg = spec.model_cfg._replace(d_feat=mol["d_feat"],
                                  n_classes=mol["n_classes"],
                                  readout="mean")
    rng = np.random.default_rng(SEED)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in {
        "x": rng.standard_normal((mol["batch"], mol["n_nodes"],
                                  mol["d_feat"])).astype(np.float32),
        "edges": rng.integers(0, mol["n_nodes"], (mol["batch"],
                                                  mol["n_edges"], 2)
                              ).astype(np.int32),
        "labels": rng.integers(0, mol["n_classes"], mol["batch"]
                               ).astype(np.int32)}.items()}
    params = gnn.init_params(torch.Generator(dev).manual_seed(SEED), cfg,
                             device=dev)
    rows.append(zoo_step_one(
        "gcn-cora/molecule", params,
        lambda p: torch.stack([gnn.forward(p, x, e, cfg) for x, e in
                               zip(batch["x"], batch["edges"])]),
        lambda p: gnn.molecule_loss(p, batch, cfg),
        (mol["batch"], mol["n_classes"]), smi))
    emit({"phase": "zoo_step", "batch": ZOO_BATCH, "models": rows,
          "seconds": time.perf_counter() - t_phase, "device": smi})
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- cells --

_CELL_DRYRUN = r"""
import json, logging, sys
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
dryrun.start_fake_fleet(1)
mesh = make_mesh((1, 1), ("data", "model"))
out = {}
for arch, shape, dims in json.loads(sys.argv[1]):
    out[f"{arch}/{shape}"] = dryrun.run_cell(arch, shape, False, None,
                                             mesh=mesh, dims=dims)
json.dump(out, open(sys.argv[2], "w"))
"""


def start_cell_dryrun(cells, path):
    """The dry-run of ``cells`` (``(arch, shape, dims)``) on a fake one-rank
    fleet, in a process of its own (the fake group is global to a
    process; this one holds a NCCL group) that touches no card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    return subprocess.Popen([sys.executable, "-c", _CELL_DRYRUN,
                             json.dumps(cells), path], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def run_cell_on_card(dev, mesh, arch, shape, dims):
    """``build_cell`` on the one-rank ``mesh``, its args drawn on the card
    from seed 0 (whole tensors: a one-rank mesh's shards), ``fn`` timed
    (median host ms of 20 after a warm-up, to ``torch.cuda.synchronize``)
    -> (cell, args, output, ms, peak allocated MB)."""
    cell = build_cell(arch, shape, mesh, dims=dims)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = cell.init_args(torch.Generator(dev).manual_seed(SEED), dev)
    out = cell.fn(*args)
    ms = host_ms(lambda: cell.fn(*args))
    torch.cuda.synchronize()
    return cell, args, out, ms, torch.cuda.max_memory_allocated() / 2 ** 20


def cell_lss_check(q, index, top_k, what):
    """The cell's LSS head on its one shard: the kernel against its plain
    version on ``q``'s rows with hash margin > MARGIN_EPS."""
    t = index.tables
    rows, check, _ = compare_lss_topk(
        augment_queries(q.float()).contiguous(), index.theta[0],
        t.table_ids[0], index.w_bucketed[0], None, top_k)
    require(rows.mean() > 1 - MAX_EXCLUDED_FRAC, f"{what}: too many rows "
            f"within the hash margin")
    return check


def phase_cells(dev, smi, counters):
    """``launch.steps.build_cell``'s cells on the card: qwen2-0.5b
    train_4k (one AdamW step, global_batch cut from 256 to what one card
    holds: CELL_TRAIN_BATCH, halved on running out of memory) and
    decode_32k (full width and depth: 128 slots x 32,768 positions, a
    51.5 GB bf16 cache, the step attending over all of it, the LSS head
    at K = 10 through ``lss_topk``), bert4rec serve_p99 (512 rows against
    1,000,000 items, K = 12, through ``lss_topk``), deepfm serve_p99 and
    gcn-cora molecule.  Each on a one-rank mesh (a world-1 NCCL group),
    its args from seed 0, ``fn`` timed, and the same cell at the same cut
    dry-run (``launch.dryrun``, a fake one-rank fleet in a subprocess of
    one thread, started once the host-bound cells are timed, the train
    cell at CELL_TRAIN_BATCH and again at the cut if the search made
    one): the three roofline terms
    on H100 figures, the bottleneck, ``useful_ratio``, and ``mfu`` =
    model_flops / (measured s x the peak of the cell's dtype).  The
    ``lss_topk`` of the decode and BERT4Rec cells against its plain
    version (outside the counts)."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="cells_dryrun_")
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    mesh = make_training_mesh((1, 1)).mesh
    results, cuts = {}, {}
    reset(counters)
    checks = {}
    for arch, shape in CELLS[1:]:
        key = f"{arch}/{shape}"
        cell, args, out, ms, peak = run_cell_on_card(dev, mesh, arch, shape,
                                                     None)
        cfg = get_arch(arch).model_cfg
        with uncounted(counters):
            if shape == "decode_32k":        # the step's q, written again
                checks[key] = cell_lss_check(T.decode_step(
                    args[0], args[1], args[2], cfg)[0], args[3], 8, key)
            elif arch == "bert4rec":
                checks[key] = cell_lss_check(recsys.bert4rec_encode(
                    args[0], args[1], cfg)[:, -1], args[2], 10, key)
        outs = ((out[1]["loss"],) if cell.donate_state
                else out[:2] if isinstance(out, tuple) else (out,))
        require(all(bool(torch.isfinite(o.float()).all()) for o in outs),
                f"cells {key}: a non-finite output")
        cuts[key] = {}
        results[key] = (cell, ms, peak)
        del cell, args, out, outs
        gc.collect()
        torch.cuda.empty_cache()
    # the dry-runs trace on the host while the card runs the train cell (a
    # step of seconds, bound by the card), not while the host-bound cells
    # above are timed: the train cell at the batch the search starts from
    # (again below if the search cuts it further)
    dims = {"qwen2-0.5b/train_4k": {"global_batch": CELL_TRAIN_BATCH}}
    dry = [start_cell_dryrun([(*c, dims.get("/".join(c))) for c in CELLS],
                             os.path.join(tmp, "dryrun.json"))]
    batch = CELL_TRAIN_BATCH
    while True:
        try:
            results["qwen2-0.5b/train_4k"] = run_cell_on_card(
                dev, mesh, "qwen2-0.5b", "train_4k", {"global_batch": batch})
            break
        except torch.cuda.OutOfMemoryError:
            results.pop("qwen2-0.5b/train_4k", None)
            gc.collect()
            torch.cuda.empty_cache()
            require(batch > 1, "cells: one train_4k row does not fit")
            batch //= 2
    cuts["qwen2-0.5b/train_4k"] = {"global_batch": [
        256, batch, f"a step of {batch * 2} rows ran out of the card's "
        f"80 GB (with each layer rematerialised: its input held, its "
        f"activations made again in the backward pass)"
        if batch < CELL_TRAIN_BATCH else "start of the search"]}
    if batch < CELL_TRAIN_BATCH:
        dry.append(start_cell_dryrun(
            [("qwen2-0.5b", "train_4k", {"global_batch": batch})],
            os.path.join(tmp, "dryrun_train.json")))
    r = results.pop("qwen2-0.5b/train_4k")
    train_loss = float(r[2][1]["loss"])
    require(np.isfinite(train_loss), "cells train_4k: loss not finite")
    results["qwen2-0.5b/train_4k"] = r[:1] + r[3:]
    del r
    gc.collect()
    torch.cuda.empty_cache()
    launches = read(counters)
    shutdown_distributed()
    t_end = time.monotonic() + CELL_DRYRUN_TIMEOUT_S
    for p in dry:
        try:
            log = p.communicate(timeout=max(1.0, t_end - time.monotonic()))[0]
        except subprocess.TimeoutExpired:
            for q in dry:
                q.kill()
            raise SmokeFailure("cells: the dry-run outlived "
                               f"{CELL_DRYRUN_TIMEOUT_S} s") from None
        require(p.returncode == 0, f"cells: the dry-run failed: "
                f"{log[-3000:]}")
    recs = json.load(open(os.path.join(tmp, "dryrun.json")))
    if batch < CELL_TRAIN_BATCH:
        recs.update(json.load(open(os.path.join(tmp, "dryrun_train.json"))))
    rows = []
    for arch, shape in CELLS:
        key = f"{arch}/{shape}"
        cell, ms, peak = results[key]
        rec = recs[key]
        roof = rec["roofline"]
        cfg = get_arch(arch).model_cfg
        dtype = str(getattr(cfg, "dtype", torch.float32)).replace("torch.",
                                                                  "")
        row = {"cell": key, "ms": ms,
               "t_compute": roof["t_compute"], "t_memory": roof["t_memory"],
               "t_collective": roof["t_collective"],
               "roofline_ms": 1e3 * max(roof["t_compute"], roof["t_memory"],
                                        roof["t_collective"]),
               "bottleneck": roof["bottleneck"], "dtype": dtype,
               "mfu": cell.model_flops / (ms / 1e3 * peak_flops(dtype)),
               "useful_ratio": roof["useful_ratio"],
               "model_flops": cell.model_flops,
               "traced_flops": rec["cost"]["flops"],
               "traced_bytes": rec["cost"]["bytes_accessed"],
               "traced_peak_gb": rec["memory"]["total_per_device_gb"],
               "traced_kernels": rec["cost"]["kernels"],
               "peak_allocated_mb": peak, "cut": cuts[key],
               "comment": cell.comment}
        if key in checks:
            row["lss_topk_check"] = checks[key]
        if key == "qwen2-0.5b/train_4k":
            row["loss"] = train_loss
        rows.append(row)
        emit({"phase": "cells", **row, "device": smi})
    # the cells' one kernel: lss_topk, in the decode and BERT4Rec heads
    # (building their indexes hashes with the plain matmul, and the
    # unfused bucket_logits path is not theirs)
    require(launches["lss_topk_cuda"] > 0, f"cells: lss_topk was not "
            f"launched ({launches})")
    emit({"phase": "cells_done", "launches": launches,
          "seconds": time.perf_counter() - t_phase, "device": smi})
    return launches


def zoo_kernel_entries(moe, arctic, bert):
    """``lss_topk`` and ``simhash_codes`` at the zoo's widths, in the
    kernels line's form, each with its path's launches and layout."""
    base = {"lss_topk": {"source": "src/repro_torch/csrc/lss_topk.cu",
                         "replaces": "src/repro/kernels/lss_topk/kernel.py:301"},
            "simhash_codes": {
                "source": "src/repro_torch/csrc/simhash_codes.cu",
                "replaces": "src/repro/kernels/simhash_codes/kernel.py:55"}}
    out = []

    def entry(name, path, launches, k, shape):
        return {"name": name, "route": "cuda", **base[name],
                "launches": launches, "max_abs_err": k["max_abs_err"],
                "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": None, "path": path, "shape": shape}

    for path, res in (("moe_decode", moe), ("arctic_decode", arctic)):
        lt, sc = res["kernels"]["lss_topk"], res["kernels"]["simhash_codes"]
        shape = {"d_aug": lt["d_aug"], "K": lt["K"], "L": lt["L"],
                 "P": lt["P"]}
        out.append(entry("lss_topk", path, res["device"]["lss_topk"],
                         lt["B8"],
                         {**shape, "B": DECODE_STREAMS,
                          "layout": lt["layout"]}))
        out.append(entry("simhash_codes", path,
                         res["launches"]["simhash_codes_cuda"], sc,
                         {**shape, "B": sc["B"], "d_tile": sc["d_tile"]}))
    k = bert["kernel"]
    out.append(entry("lss_topk", "bert4rec_serve",
                     bert["launches"]["lss_topk_cuda"], k,
                     {key: k[key] for key in ("B", "d_aug", "K", "L", "P",
                                              "layout")}))
    return out


# ------------------------------------------------------- online refresh --

@contextlib.contextmanager
def graph_entry_capture():
    """Every ``CUDAGraph.capture_begin`` inside first does what
    ``torch.cuda.graph``'s entry does: synchronise the device, empty the
    device cache and the pinned host cache.  The port's capture
    (``serve.step``) does none of it; one refresh cycle runs with it to
    show what it would cost the requests served during that swap."""
    real = torch.cuda.CUDAGraph.capture_begin
    host_empty = getattr(torch._C, "_host_emptyCache", lambda: None)

    def begin(self, *args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        host_empty()
        return real(self, *args, **kwargs)

    torch.cuda.CUDAGraph.capture_begin = begin
    try:
        yield
    finally:
        torch.cuda.CUDAGraph.capture_begin = real


def timed_cycles(eng, refresher):
    """Wrap the refresher's refit and the engine's swap, warm and flip so
    each ``refresh_once`` cycle records its host times (perf_counter
    stamps and seconds) into the list returned."""
    cycles = []
    refit, swap = refresher._refit, eng.swap_index
    warm, flip = eng.warm_epoch, eng._swap_prepared

    def timed_refit():
        t0 = time.perf_counter()
        cycles.append({"t_refit": t0})
        out = refit()
        cycles[-1]["refit_s"] = time.perf_counter() - t0
        return out

    def timed_swap(index, *, warm=True):
        c = cycles[-1]
        c["t_swap"] = time.perf_counter()
        epoch = swap(index, warm=warm)
        c["t_swap_end"] = time.perf_counter()
        return epoch

    def timed_warm(epoch, shapes=None):
        t0 = time.perf_counter()
        warm(epoch, shapes)
        cycles[-1]["warm_s"] = time.perf_counter() - t0

    def timed_flip(epoch):
        t0 = time.perf_counter()
        out = flip(epoch)
        cycles[-1]["flip_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    refresher._refit = timed_refit
    eng.swap_index = timed_swap
    eng.warm_epoch = timed_warm
    eng._swap_prepared = timed_flip
    return cycles


def paced_until(rt, rows, qps, stop, seed):
    """Submit ``rows`` in turn at Poisson arrivals of rate ``qps`` until
    ``stop`` is set; returns the futures."""
    rng = np.random.default_rng(seed)
    futs, t, i = [], time.perf_counter(), 0
    while not stop.is_set():
        t += rng.exponential(1.0 / qps)
        dt = t - time.perf_counter()
        if dt > 0:
            time.sleep(dt)
        futs.append(rt.submit(rows[i % len(rows)]))
        i += 1
    return futs


def latency_split(futs, windows):
    """p50/p99 ms of the requests whose flight overlaps each kind of
    window in ``windows`` ({kind: [(t0, t1)]}; a request counts for the
    first kind it overlaps) and of the rest."""
    groups = {kind: [] for kind in windows}
    groups["rest"] = []
    for f in futs:
        lat = (f.t_done - f.t_submit) * 1e3
        for kind, spans in windows.items():
            if any(f.t_submit < t1 + REFRESH_MARGIN_S and f.t_done > t0
                   for t0, t1 in spans):
                groups[kind].append(lat)
                break
        else:
            groups["rest"].append(lat)
    return {kind: {"n": len(v),
                   "p50_ms": float(np.percentile(v, 50)) if v else None,
                   "p99_ms": float(np.percentile(v, 99)) if v else None}
            for kind, v in groups.items()}


def flush_rows(eng, rows, seed):
    """``rows`` through ``submit``/``flush`` in ragged groups of 1-47;
    the results stacked in submit order."""
    rng = np.random.default_rng(seed)
    res, i = [], 0
    while i < rows.shape[0]:
        n = min(int(rng.integers(1, 48)), rows.shape[0] - i)
        for j in range(i, i + n):
            eng.submit(rows[j])
        res += eng.flush()
        i += n
    return stack_results(res)


def mem_mb():
    torch.cuda.synchronize()
    return {"allocated_mb": torch.cuda.memory_allocated() / 2 ** 20,
            "reserved_mb": torch.cuda.memory_reserved() / 2 ** 20}


def refresh_counter(name):
    return obs.registry().counter(name).value


def phase_refresh_capture(eng, rows, targets, smi):
    """The open loop at ``SERVE_QPS`` while ``CAPTURE_SWAPS`` swaps run
    0.5 s apart, each to the next of ``targets`` in turn (a new epoch a
    swap, its LSS steps captured anew), the odd ones with
    ``torch.cuda.graph``'s entry at each capture: p50/p99 of the requests
    in flight during each kind of swap against the rest."""
    spans = {"port": [], "graph_entry": []}
    stop = threading.Event()

    def swapper():
        try:
            for i in range(CAPTURE_SWAPS):
                time.sleep(0.5)
                kind = "graph_entry" if i % 2 else "port"
                t0 = time.perf_counter()
                with (graph_entry_capture() if i % 2
                      else contextlib.nullcontext()):
                    eng.swap_index(targets[i % len(targets)])
                spans[kind].append((t0, time.perf_counter()))
            time.sleep(0.5)
        finally:
            stop.set()

    rt = AsyncRuntime(eng, head="lss", max_queue=1 << 20, policy="block")
    th = threading.Thread(target=swapper, name="capture-swaps")
    th.start()
    futs = paced_until(rt, rows, SERVE_QPS, stop, SEED + 1)
    th.join(timeout=600.0)
    rt.drain(timeout=600.0)
    rt.close(timeout=60.0)
    n_failed = sum(f.exception(timeout=1.0) is not None for f in futs)
    require(not th.is_alive() and n_failed == 0,
            f"refresh_capture: {n_failed} futures failed")
    out = {"phase": "refresh_capture", "qps": SERVE_QPS,
           "requests": len(futs), "failed_futures": n_failed,
           "swap_s": {k: [t1 - t0 for t0, t1 in v]
                      for k, v in spans.items()},
           "latency": latency_split(futs, spans), "device": smi}
    emit(out)
    return out


def phase_refresh(dev, smi, res, counters):
    """Online index refresh on ``train_wol``'s model and index: an
    ``Engine(None, w, b, ...)`` over the model's query embeddings (so
    ``warm_epoch`` captures every LSS bucket's step), its calibration
    snapshot the rows ``train_wol``'s ``fit_lss`` used.

    ``refresh_swap`` (the counted run): the AsyncRuntime in open loop at
    ``SERVE_QPS`` (policy block) while a thread runs
    ``REFRESH_CYCLES`` ``refresh_once`` cycles (one IUL epoch on the full
    WOL, build, warm, flip); per cycle the refit, warm and flip times;
    p50/p99 of the requests whose flight overlaps a swap (or a refit)
    against the rest; no failed future; the memory before, at peak and
    after, the dropped epochs' steps gone.  ``refresh_capture``: the same
    open loop while ``CAPTURE_SWAPS`` swaps to indexes already built run
    0.5 s apart, in turns with the port's capture and with
    ``torch.cuda.graph``'s entry at each capture
    (``graph_entry_capture``): the captures' own cost to the requests in
    flight, no refit beside them.  Then the engine's LSS results on
    ``SERVE_REQUESTS`` rows are bit for bit ``lss_forward``'s and a cold
    engine's on the final index.
    ``refresh_rollback``: the auditor at rate 1.0 under traffic, probation
    armed to read recall 0: rolled back, the rollback counter 1, the
    pre-swap index served bit for bit, one epoch left.  ``refresh_fail``:
    an injected refit exception, then a NaN θ: both fail, serving is
    unchanged, and ``lss_refresh_failures_total`` is the injected count.
    Returns the counted run's launches and the injected failures."""
    t_phase = time.perf_counter()
    model, index, lss_cfg, data = (res["model"], res["index"],
                                   res["lss_config"], res["data"])
    n_test = res["n_test"]
    w, b = model.w_out.float(), model.b_out.float()
    q_all = torch.cat([model.embed(torch.from_numpy(
        data.x[i:i + BATCH]).to(dev)) for i in range(0, len(data.x), BATCH)])
    lab = torch.from_numpy(data.labels).to(dev)
    calib = (q_all[n_test:], lab[n_test:])       # fit_lss's rows
    rows = q_all.cpu().numpy()
    eng = Engine(None, w, b, lss_cfg, top_k=TOP_K, head="lss")
    eng._set_index(index)
    buckets = eng.batcher.buckets
    for bk in buckets:
        eng._step("lss", bk)(rows[:bk])
    first = [weakref.ref(s) for s in eng._epoch_state().steps.values()]
    require(all(ref().captured for ref in first),
            "refresh: the serving steps are not captured")
    failures0 = refresh_counter("lss_refresh_failures_total")

    # refresh_swap: the counted run
    refresher = IndexRefresher(eng, auditor=None, calib=calib, seed=SEED,
                               cfg=RefreshConfig(warm=True))
    cycles = timed_cycles(eng, refresher)
    outcomes, stop = [], threading.Event()

    def refresh_loop():
        try:
            time.sleep(0.5)                      # steady traffic first
            for _ in range(REFRESH_CYCLES):
                outcomes.append(refresher.refresh_once())
            time.sleep(0.5)
        finally:
            stop.set()

    gc.collect()
    torch.cuda.empty_cache()
    mem0 = mem_mb()
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    rt = AsyncRuntime(eng, head="lss", max_queue=1 << 20, policy="block")
    th = threading.Thread(target=refresh_loop, name="refresh-cycles")
    t0 = time.perf_counter()
    th.start()
    futs = paced_until(rt, rows, SERVE_QPS, stop, SEED)
    th.join(timeout=600.0)
    rt.drain(timeout=600.0)
    swap_s = time.perf_counter() - t0
    stats = rt.stats()
    rt.close(timeout=60.0)
    launches = read(counters)
    peak = {"allocated_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
            "reserved_mb": torch.cuda.max_memory_reserved() / 2 ** 20}
    require(not th.is_alive(), "refresh_swap: the refresh thread hangs")
    n_failed = sum(f.exception(timeout=1.0) is not None for f in futs)
    require(outcomes == ["swapped"] * REFRESH_CYCLES
            and refresher.n_failed == 0,
            f"refresh_swap: outcomes {outcomes}, last error "
            f"{refresher.last_error}")
    require(n_failed == 0, f"refresh_swap: {n_failed} futures failed")
    require(launches["simhash_codes_cuda"] > 0
            and launches["lss_topk_cuda"]
            == 2 * len(buckets) * REFRESH_CYCLES
            and launches["bucket_logits_cuda"] == 0,
            f"refresh_swap: wrapper launches {launches}, not the refits' "
            f"simhash_codes and a warm-up and a capture of lss_topk for "
            f"each of {len(buckets)} buckets a cycle")
    windows = {"swap": [(c["t_swap"], c["t_swap_end"]) for c in cycles],
               "refit": [(c["t_refit"], c["t_refit"] + c["refit_s"])
                         for c in cycles]}
    lat = latency_split(futs, windows)
    del futs
    gc.collect()
    released = release_graphs()
    torch.cuda.empty_cache()
    mem1 = mem_mb()
    require(len(eng._epochs) == 1 and not step_mod._DEAD
            and all(ref() is None for ref in first),
            "refresh_swap: a dropped epoch's steps are still alive")
    emit({"phase": "refresh_swap", "qps": SERVE_QPS,
          "requests": stats.n_completed, "failed_futures": n_failed,
          "seconds": swap_s, "outcomes": outcomes,
          "cycles": [{"refit_s": c["refit_s"], "warm_s": c["warm_s"],
                      "flip_ms": c["flip_ms"],
                      "swap_s": c["t_swap_end"] - c["t_swap"]}
                     for c in cycles],
          "latency": lat, "runtime": stats._asdict(),
          "calib_recall": refresher.last_info.get("recall"),
          "launches": launches, "memory_before": mem0, "memory_peak": peak,
          "memory_after": mem1, "graphs_released_after": released,
          "epoch": eng.index_epoch, "device": smi})

    with uncounted(counters):
        # refresh_capture: swaps alone, the port's capture and
        # torch.cuda.graph's entry in turns; the last one serves `final`
        final = eng.index
        capture = phase_refresh_capture(eng, rows, [index, final], smi)

        # the final index: bit for bit lss_forward's and a cold engine's
        require(eng.index is final, "refresh_capture: not the final index")
        x = rows[:SERVE_REQUESTS]
        got = flush_rows(eng, x, SEED)
        ref = [lss_forward(q_all[i:i + BATCH], final, None, TOP_K)
               for i in range(0, SERVE_REQUESTS, BATCH)]
        ref_lg = torch.cat([r.top_logits for r in ref]).cpu().numpy()
        ref_ids = torch.cat([r.top_ids for r in ref]).cpu().numpy()
        require(same_bits(got[0], ref_lg) and same_bits(got[1], ref_ids),
                "refresh_swap: the swapped engine differs from lss_forward")
        cold = Engine(None, w, b, lss_cfg, top_k=TOP_K, head="lss")
        cold._set_index(final)
        want = flush_rows(cold, x, SEED)
        require(same_bits(got[0], want[0]) and same_bits(got[1], want[1]),
                "refresh_swap: the swapped engine differs from a cold one")
        del cold

        # refresh_rollback: the auditor at 1.0, probation reads recall 0
        for bk in buckets:
            eng._step("full", bk)(rows[:bk])     # the auditor's steps
        eng.auditor = RecallAuditor(eng, 1.0, queue_cap=4096)
        x8 = rows[:8]
        pre = eng.rank(x8, record=False)
        idx_before = eng.index
        for i in range(32):                      # the pre-swap baseline
            eng.rank(rows[8 * i:8 * i + 8])
        eng.auditor.drain(timeout=600.0)
        rollback_ref = IndexRefresher(
            eng, calib=calib, seed=SEED + 1,
            cfg=RefreshConfig(probation_s=120.0, min_audit_rows=64,
                              probation_poll_s=0.02, rollback_delta=0.0))
        stop_traffic = threading.Event()

        def traffic():
            i = 0
            while not stop_traffic.is_set():
                eng.rank(rows[8 * (i % 256):8 * (i % 256) + 8])
                i += 1
                time.sleep(0.002)

        tt = threading.Thread(target=traffic, name="rollback-traffic")
        tt.start()
        t0 = time.perf_counter()
        try:
            with faults.injected(faults.REFRESH_PROBATION,
                                 lambda ctx: ctx.__setitem__("recall", 0.0)):
                outcome = rollback_ref.refresh_once()
        finally:
            stop_traffic.set()
            tt.join(timeout=60.0)
        rollback_s = time.perf_counter() - t0
        post = eng.rank(x8, record=False)
        require(outcome == "rolled_back" and rollback_ref.n_rollbacks == 1
                and refresh_counter("lss_refresh_rollback_total") == 1,
                f"refresh_rollback: outcome {outcome}, last error "
                f"{rollback_ref.last_error}")
        require(eng.index is idx_before and len(eng._epochs) == 1
                and same_tensor_bits(post.logits, pre.logits)
                and same_tensor_bits(post.ids, pre.ids),
                "refresh_rollback: the pre-swap index is not served as it "
                "was")
        eng.auditor.drain(timeout=600.0)
        audited = eng.auditor.snapshot()
        eng.auditor.close()
        eng.auditor = None
        emit({"phase": "refresh_rollback", "outcome": outcome,
              "seconds": rollback_s, "epoch": eng.index_epoch,
              "epochs": len(eng._epochs), "audited_rows": audited[1],
              "rollback_total": refresh_counter(
                  "lss_refresh_rollback_total"),
              "served": "the pre-swap index, bit for bit", "device": smi})

        # refresh_fail: an exception, then a NaN theta, in the refit
        pre = eng.rank(rows[:BATCH], record=False)
        epoch = eng.index_epoch

        def poison(ctx):
            refresher._state = refresher._state._replace(
                theta=torch.full_like(refresher._state.theta, float("nan")))

        got = []
        for action in (RuntimeError("injected refit failure"), poison):
            with faults.injected(faults.REFRESH_REFIT, action):
                got.append((refresher.refresh_once(), refresher.last_error))
        post = eng.rank(rows[:BATCH], record=False)
        injected = 2
        failures = refresh_counter("lss_refresh_failures_total") - failures0
        require([o for o, _ in got] == ["failed", "failed"]
                and failures == injected and eng.index_epoch == epoch
                and same_tensor_bits(post.logits, pre.logits)
                and same_tensor_bits(post.ids, pre.ids),
                f"refresh_fail: outcomes {got}, {failures} failures counted "
                f"for {injected} injected")
    emit({"phase": "refresh_fail", "outcomes": [o for o, _ in got],
          "errors": [e for _, e in got], "failures_total": failures,
          "injected": injected, "served": "unchanged, bit for bit",
          "seconds": time.perf_counter() - t_phase, "device": smi})
    return launches, injected


def phase_refresh_decode(dev, smi, counters, state, injected):
    """A swap mid-decode at Qwen2-0.5B's full width, on the ``decode``
    phase's params, dense decoder and index, to a second index fitted
    from another generator: ``DECODE_STREAMS`` sessions in flight keep
    their pinned epoch (their tokens the blocking no-swap ones, bit for
    bit); sessions admitted after the drain run the new epoch (bit for
    bit a cold decoder's on it), whose fused step is built exactly once
    (its capture's ms is the ITL gap it cost) while the old epoch's steps
    are freed.  Then the serve launcher's LSS fit (K = 6) on the same
    head: its P and C, and ``lss_topk`` at that shape against its plain
    version and its bound.  The refresher failures over the refresh
    phases must be the injected ones.  Returns the counted run's
    launches."""
    t_phase = time.perf_counter()
    dec, prompts, blocking = state["dense"], state["prompts"], \
        state["blocking"]
    eng = dec.engine
    q_calib, lab_calib = eng.calib
    lss_cfg = eng.lss_cfg
    with uncounted(counters):
        t0 = time.perf_counter()
        idx2, _ = fit_lss(torch.Generator(dev).manual_seed(SEED + 2),
                          q_calib, lab_calib, eng.w, eng.b, lss_cfg)
        fit2_s = time.perf_counter() - t0
    require(not torch.equal(idx2.theta, dec.index.theta),
            "refresh_decode: the second index is the first")
    sched = dec.scheduler("lss")
    key = ("lss", sched._tag)
    builds0 = eng.compile_counts[key]
    pinned = prompts[:DECODE_STREAMS]

    reset(counters)
    streams = [sched.submit(p, max_new_tokens=DECODE_NEW) for p in pinned]
    for _ in range(4):
        sched.tick()
    require(sched.pool.n_active == DECODE_STREAMS,
            "refresh_decode: the sessions are not in flight")
    e_old = sched._epoch
    old_steps = [weakref.ref(s) for s in eng._epochs[e_old].steps.values()]
    t0 = time.perf_counter()
    e_new = eng.swap_index(idx2)
    swap_s = time.perf_counter() - t0
    require(eng.index_epoch == e_new and sched._epoch == e_old,
            "refresh_decode: the swap reached the pinned generation")
    sched.run(timeout=600.0)
    toks = [s.result(timeout=60.0) for s in streams]
    dropped = e_old not in eng._epochs
    gc.collect()
    release_graphs()
    freed = all(ref() is None for ref in old_steps)
    after = [sched.submit(p, max_new_tokens=DECODE_NEW)
             for p in prompts[DECODE_STREAMS:2 * DECODE_STREAMS]]
    sched.run(timeout=600.0)
    toks2 = [s.result(timeout=60.0) for s in after]
    launches = read(counters)
    new_step = eng._epochs[e_new].steps[key]
    capture_ms = new_step.build_s * 1e3
    itl = np.concatenate([s.inter_token_s() for s in after]) * 1e3
    require(all(np.array_equal(a, b) for a, b in zip(toks, blocking["lss"])),
            "refresh_decode: a pinned session's tokens moved with the swap")
    require(dropped and freed and not step_mod._DEAD,
            "refresh_decode: the old epoch's steps are still alive")
    require(eng.compile_counts[key] == builds0 + 1,
            f"refresh_decode: the new epoch's fused step built "
            f"{eng.compile_counts[key] - builds0} times")
    require(launches["lss_topk_cuda"] > 0
            and launches["bucket_logits_cuda"] == 0,
            f"refresh_decode: wrapper launches {launches}")
    check_prefills(launches, dec.cfg.n_layers, "refresh_decode")
    with uncounted(counters):
        cold = LMDecoder(state["params"], dec.cfg, lss_cfg,
                         max_streams=DECODE_STREAMS, max_len=DECODE_MAX_LEN,
                         kv_layout="dense")
        cold.engine._set_index(idx2)
        want = run_sessions(cold.scheduler("lss"),
                            prompts[DECODE_STREAMS:2 * DECODE_STREAMS],
                            DECODE_NEW)
        require(all(np.array_equal(a, b) for a, b in zip(toks2, want)),
                "refresh_decode: the new generation differs from a cold "
                "decoder on the new index")
        del cold
        release_graphs()
    emit({"phase": "refresh_decode", "model": dec.cfg.name,
          "sessions_in_flight": DECODE_STREAMS, "new_tokens": DECODE_NEW,
          "second_index_fit_s": fit2_s, "swap_s": swap_s,
          "pinned": "bit for bit the no-swap blocking tokens",
          "after_drain": "bit for bit a cold decoder on the new index",
          "fused_step_builds": eng.compile_counts[key] - builds0,
          "fused_step_capture_ms": capture_ms,
          "itl_after_drain_ms": {"median": float(np.median(itl)),
                                 "max": float(itl.max())},
          "old_epoch_freed": freed, "launches": launches,
          "seconds": time.perf_counter() - t_phase, "device": smi})

    # the serve launcher's LSS fit (K = 6) on the same head, and lss_topk
    # at its shape
    with uncounted(counters):
        t0 = time.perf_counter()
        idx6, _ = fit_lss(torch.Generator(dev).manual_seed(SEED + 3),
                          q_calib, lab_calib, eng.w, eng.b, LAUNCH_LSS)
        fit6_s = time.perf_counter() - t0
        t = idx6.tables
        hidden = state["hidden"]
        kernels = decode_kernels(idx6, hidden, q_calib, smi)
        failures = refresh_counter("lss_refresh_failures_total")
        require(failures == injected,
                f"refresh: {failures} refresher failures, {injected} "
                f"injected")
    emit({"phase": "refresh_launcher_index", "K": t.k_bits,
          "L": t.n_tables, "P": t.capacity, "C": t.n_tables * t.capacity,
          "n_dropped": int(t.n_dropped.sum()), "fit_s": fit6_s,
          "slab_mb_per_query": t.n_tables * t.capacity
          * idx6.w_bucketed.shape[-1] * idx6.w_bucketed.element_size()
          / 2 ** 20, **kernels, "refresher_failures": failures,
          "injected": injected, "device": smi})
    return launches


# ------------------------------------------------------------ launchers --

def run_launcher(module, args, timeout):
    """``python -m module args`` from the repository root, as a user runs
    it (the device left at its default); its stdout and seconds.  A
    non-zero exit fails the run with the end of its output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cmd = [sys.executable, "-m", module, *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SmokeFailure(
            f"launch: {' '.join(cmd[2:])} exited {proc.returncode}:\n"
            f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout, seconds


def grab(pattern, text, what):
    m = re.search(pattern, text)
    require(m is not None, f"launch: no {what} line in\n{text[-3000:]}")
    return m


def launcher_counts(out):
    """The serve launcher's refresher counts, builds and kernel
    launches, read off its output."""
    r = grab(r"index refresh: swaps=(\d+) rollbacks=(\d+) failures=(\d+) "
             r"epoch=(\d+)", out, "refresher")
    refresh = dict(zip(("swaps", "rollbacks", "failures", "epoch"),
                       map(int, r.groups())))
    builds = ast.literal_eval(grab(r"engine compiles \(head, \w+\): "
                                   r"(\{.*\})", out, "builds").group(1))
    launches = ast.literal_eval(grab(r"kernel launches: (\{.*\})", out,
                                     "kernel launches").group(1))
    return refresh, builds, launches


def phase_launch(smi):
    """The port's launchers as a user runs them, at full width, on the
    card: ``repro_torch.launch.serve`` streaming decode with online
    refresh every second at ``LAUNCH_QPS`` sessions a second (the pool
    drains between sessions, so swapped-in epochs serve new
    generations): every session served, no refresher failure, a swap,
    the LSS fused step built under at least two epochs; the same
    launcher's async scoring at 5,000 req/s with the auditor and
    /metrics; ``repro_torch.launch.train`` twice on one checkpoint
    directory, the second run resuming.  Returns each serve run's kernel
    launches."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    base = ["--arch", "qwen2-0.5b", "--train-steps", str(LAUNCH_TRAIN_STEPS),
            "--head", "lss", "--steps", "32", "--refresh-interval", "1"]
    runs, launches = {}, {}
    out, secs = run_launcher(
        "repro_torch.launch.serve",
        base + ["--mode", "decode", "--streams", "8", "--sessions", "32",
                "--qps", str(LAUNCH_QPS)], 900)
    refresh, builds, launches["serve_decode"] = launcher_counts(out)
    idx = grab(r"LSS index: K=(\d+) L=(\d+) P=(\d+) C=(\d+)", out,
               "index").groups()
    itl = grab(r"itl p50=([\d.]+) p95=([\d.]+) p99=([\d.]+)", out,
               "ITL").groups()
    fused = [n for (kind, tag), n in builds.items()
             if kind == "lss" and str(tag).startswith("decode[")]
    require("32/32 sessions served" in out, "launch decode: sessions lost")
    require(refresh["failures"] == 0 and refresh["swaps"] >= 1,
            f"launch decode: refresher {refresh}")
    require(len(fused) == 1 and fused[0] >= 2,
            f"launch decode: the LSS fused step built {fused} times: no "
            f"generation ran on a swapped-in epoch")
    require(launches["serve_decode"]["lss_topk_cuda"] > 0
            and launches["serve_decode"]["simhash_codes_cuda"] > 0,
            f"launch decode: kernel launches {launches['serve_decode']}")
    runs["serve_decode"] = {
        "seconds": secs, "refresh": refresh, "fused_step_builds": fused[0],
        "index": dict(zip("KLPC", map(int, idx))),
        "itl_ms": dict(zip(("p50", "p95", "p99"), map(float, itl))),
        "launches": launches["serve_decode"]}

    out, secs = run_launcher(
        "repro_torch.launch.serve",
        base + ["--runtime", "async", "--qps", "5000", "--audit-rate",
                "0.25", "--metrics-port", "0"], 900)
    refresh, builds, launches["serve_async"] = launcher_counts(out)
    lat = grab(r"p50=([\d.]+) p95=([\d.]+) p99=([\d.]+) ms \(incl", out,
               "latency").groups()
    require("512/512 served" in out and "metrics: http://" in out,
            "launch async: requests lost or no /metrics")
    require(refresh["failures"] == 0 and refresh["swaps"] >= 1,
            f"launch async: refresher {refresh}")
    runs["serve_async"] = {
        "seconds": secs, "refresh": refresh,
        "latency_ms": dict(zip(("p50", "p95", "p99"), map(float, lat))),
        "launches": launches["serve_async"]}

    with tempfile.TemporaryDirectory(prefix="launch_train_") as tmp:
        n = LAUNCH_TRAIN_STEPS
        args = ["--arch", "qwen2-0.5b", "--steps", str(n), "--ckpt-dir", tmp]
        first, s1 = run_launcher("repro_torch.launch.train", args, 900)
        again, s2 = run_launcher("repro_torch.launch.train", args, 900)
    loss = grab(rf"done: step {n} loss ([\d.]+)", first, "train").group(1)
    require(f"[trainer] resumed from step {n}" in again
            and f"resumed at step {n}: nothing left to train" in again,
            f"launch train: the rerun did not resume:\n{again[-2000:]}")
    runs["train"] = {"seconds": [s1, s2], "loss": float(loss),
                     "rerun": f"resumed at step {n}"}
    emit({"phase": "launch", **runs, "launch_qps": LAUNCH_QPS,
          "seconds": time.perf_counter() - t_phase, "device": smi})
    return launches


def bucket_logits_entry(index, q_aug0, launches):
    """bucket_logits at the unfused path's shapes (its first batch)."""
    w_flat, slab_ids = slab_inputs(q_aug0, index)
    check = compare_bucket_logits(q_aug0, w_flat, slab_ids)
    emit({"phase": "unfused_path_kernel_check", **check})
    ms = time_ms(lambda: bucket_logits(q_aug0, w_flat, slab_ids))
    plain = time_ms(lambda: bucket_logits_ref(q_aug0, w_flat, slab_ids),
                    iters=5)
    b_ms, b_by, _, _, _ = bucket_logits_bound_ms(q_aug0, w_flat, slab_ids)
    return {"name": "bucket_logits", "route": "cuda",
            "source": "src/repro_torch/csrc/bucket_logits.cu",
            "replaces": "src/repro/kernels/bucket_logits/kernel.py:63",
            "launches": launches["bucket_logits_cuda"],
            "max_abs_err": check["max_abs_err"], "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def kernel_line(index, q0, launches):
    """The two kernels at the main path's shapes (its first batch)."""
    t = index.tables
    q_aug = augment_queries(q0)
    args = (q_aug, index.theta, t.table_ids, index.w_bucketed)
    _, check, got = compare_lss_topk(*args, None, TOP_K)
    emit({"phase": "main_path_kernel_check", **check})
    ms = time_ms(lambda: lss_topk(*args, top_k=TOP_K))
    plain = time_ms(lambda: lss_topk_ref(*args, top_k=TOP_K), iters=5)
    b_ms, b_by, _, _ = lss_topk_bound_ms(q_aug, index, got[3], TOP_K)
    code_args = (unit(q_aug), index.theta, t.k_bits, t.n_tables)
    _, s_err = compare_simhash(*code_args)
    s_ms = time_ms(lambda: simhash_codes(*code_args))
    s_plain = time_ms(lambda: simhash_codes_ref(*code_args))
    s_b, s_by, _, _ = simhash_bound_ms(*q_aug.shape, t.k_bits, t.n_tables)
    return {"kernels": [
        {"name": "simhash_codes", "route": "cuda",
         "source": "src/repro_torch/csrc/simhash_codes.cu",
         "replaces": "src/repro/kernels/simhash_codes/kernel.py:55",
         "launches": launches["simhash_codes_cuda"], "max_abs_err": s_err,
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_b, "bound_by": s_by,
         "library_ms": None},
        {"name": "lss_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/lss_topk.cu",
         "replaces": "src/repro/kernels/lss_topk/kernel.py:301",
         "launches": launches["lss_topk_cuda"],
         "max_abs_err": check["max_abs_err"],
         "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": None},
    ]}


@torch.no_grad()
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev, smi = phase_device()
    phase_build()
    phase_launch_floor(dev)

    cfg = DELICIOUS.full
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = XCModel(cfg, generator=gen, device=dev)
    w_aug = augment_neurons(model.w_out, model.b_out)
    theta = init_hyperplanes(gen, cfg.hidden + 1, DELICIOUS.lss.k_bits,
                             DELICIOUS.lss.n_tables, device=dev)
    index = build_index(w_aug, theta, DELICIOUS.lss)
    data = xc_dataset(SEED, N_REQUESTS, cfg.input_dim, cfg.output_dim,
                      max_in=cfg.max_in, max_labels=cfg.max_labels)
    torch.cuda.synchronize()
    t = index.tables
    emit({"phase": "setup", "model": cfg.name, "input_dim": cfg.input_dim,
          "hidden": cfg.hidden, "output_dim": cfg.output_dim,
          "K": t.k_bits, "L": t.n_tables, "P": t.capacity,
          "C": t.n_tables * t.capacity, "n_dropped": int(t.n_dropped.sum()),
          "device_memory_mb": torch.cuda.memory_allocated() / 2 ** 20,
          "seconds": time.perf_counter() - t0})

    q_main = model.embed(torch.from_numpy(data.x[:BATCH]).to(dev))
    phase_simhash(dev, gen, augment_queries(q_main))
    phase_lss_topk(dev, gen, w_aug, DELICIOUS)
    phase_bucket_logits(dev, gen, w_aug, DELICIOUS)
    attention = phase_decode_attention(dev)
    prefill = phase_prefill_attention(dev)
    launches, q0 = phase_main_path(
        dev, model, index, data,
        (simhash_codes_cuda, lss_topk_ops.lss_topk_cuda))
    line = kernel_line(index, q0, launches)
    counters = (simhash_codes_cuda, lss_topk_ops.lss_topk_cuda,
                bucket_logits_cuda)
    learned = phase_iul(dev, model, DELICIOUS, counters)
    u_launches, q_aug0 = phase_unfused_path(dev, model, learned, data,
                                            counters)
    line["kernels"].append(bucket_logits_entry(learned, q_aug0, u_launches))
    res = phase_train_wol(dev, counters)
    # the paper's experiments at the reference's full-pass sizes
    # (BENCH_FAST=0; Table 2 at the fast pass's)
    paper_tables.FAST = False
    phase_paper_table1_full(dev, smi, res, counters)
    serve_launches, runtime_launches = phase_serve_engine(
        dev, smi, res["model"], res["index"], res["lss_config"], res["data"],
        counters)
    sharded_launches = phase_sharded_index(
        dev, smi, res["model"], res["index"], res["lss_config"], res["data"],
        counters)
    sharded_engine_device = phase_sharded_engine(
        dev, smi, res["model"], res["index"], res["lss_config"], res["data"],
        counters)
    fleet_reports = phase_fleet(dev, smi, res["model"], res["index"],
                                res["lss_config"], res["data"])
    sharded_train_launches = phase_sharded_train(dev, smi)
    refresh_launches, injected = phase_refresh(dev, smi, res, counters)
    del res
    # the decode paths also count the attention wrappers' launches and the
    # prompts' forwards
    decode_counters = counters + (decode_attention_cuda,
                                  prefill_attention_cuda,
                                  count_prefill_forwards())
    decode_launches, decode_device, decode_state = phase_decode(
        dev, smi, decode_counters)
    refresh_decode_launches = phase_refresh_decode(
        dev, smi, decode_counters, decode_state, injected)
    del decode_state
    launch_launches = phase_launch(smi)
    fleet_launch_launches = phase_fleet_launch(smi)
    for entry in line["kernels"][:2]:
        name = entry["name"] + "_cuda"
        entry["launches_by_path"] = {
            "main_path": entry["launches"],
            "refresh": refresh_launches[name],
            "refresh_decode": refresh_decode_launches[name],
            "launch": {run: n[name] for run, n in launch_launches.items()},
            "fleet_launch": {run: {rank: n[name] for rank, n in by.items()}
                             for run, by in fleet_launch_launches.items()}}
    line["kernels"][0]["launches_by_path"]["decode"] = \
        decode_launches["simhash_codes_cuda"]
    line["kernels"][1]["launches_by_path"].update(
        serve_engine=serve_launches, serve_runtime_trace=runtime_launches,
        decode=decode_device["lss_topk"],
        sharded_index={k: n["lss_topk_cuda"]
                       for k, n in sharded_launches.items()},
        sharded_engine=sharded_engine_device,
        fleet={r["rank"]: r["profiler_lss_topk_kernels"]
               for r in fleet_reports},
        sharded_train=sharded_train_launches)
    phase_preemption(dev)
    phase_paper_table1(dev, smi, counters)
    phase_paper_table2(dev, smi, counters)
    phase_paper_fig2(dev, counters)
    # the rest of the model zoo
    moe = phase_moe_decode(dev, smi, decode_counters)
    arctic = phase_arctic_decode(dev, smi, decode_counters)
    bert = phase_bert4rec_serve(dev, smi, counters)
    phase_zoo_step(dev, smi)
    cells_launches = phase_cells(dev, smi, counters)
    for entry, name in zip(line["kernels"][:2], ("simhash_codes_cuda",
                                                  "lss_topk_cuda")):
        entry["launches_by_path"].update(
            moe_decode=moe["launches"][name],
            arctic_decode=arctic["launches"][name],
            bert4rec_serve=bert["launches"][name])
    line["kernels"][1]["launches_by_path"].update(
        moe_decode_profiler=moe["device"]["lss_topk"],
        arctic_decode_profiler=arctic["device"]["lss_topk"])
    for entry in line["kernels"]:
        entry.setdefault("launches_by_path", {})["cells"] = \
            cells_launches[entry["name"] + "_cuda"]
    line["kernels"].extend(zoo_kernel_entries(moe, arctic, bert))
    # the decode step's kernel: the wrapper's launches (a warm-up and a
    # capture a layer and decode step) and the profiler's decode_attn
    # kernels (two a layer, a replayed step and a warm-up) on each path
    attention["launches"] = decode_launches["decode_attention_cuda"]
    attention["launches_by_path"] = {
        "decode": decode_launches["decode_attention_cuda"],
        "decode_profiler": decode_device["decode_attn"],
        "moe_decode": moe["launches"]["decode_attention_cuda"],
        "moe_decode_profiler": moe["device"]["decode_attn"],
        "arctic_decode": arctic["launches"]["decode_attention_cuda"],
        "arctic_decode_profiler": arctic["device"]["decode_attn"]}
    line["kernels"].append(attention)
    # the prefill kernel's wrapper launches and the prompt forwards on each
    # model path (one launch a layer a forward, checked on each path)
    prefill["launches"] = decode_launches["prefill_attention_cuda"]
    prefill["launches_by_path"] = {
        path: {"launches": n["prefill_attention_cuda"],
               "forwards": n["prefill_forwards"]}
        for path, n in (("decode", decode_launches),
                        ("refresh_decode", refresh_decode_launches),
                        ("moe_decode", moe["launches"]),
                        ("arctic_decode", arctic["launches"]))}
    line["kernels"].append(prefill)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit(line)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fleet-worker"]:
        with torch.no_grad():
            sys.exit(fleet_worker(int(sys.argv[2]), sys.argv[3],
                                  int(sys.argv[4])))
    if sys.argv[1:2] == ["--train-worker"]:
        with torch.no_grad():
            sys.exit(train_worker(int(sys.argv[2]), sys.argv[3],
                                  int(sys.argv[4])))
    sys.exit(main())
