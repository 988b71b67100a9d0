"""Public op: bucket-major sparse WOL logits, dispatched through the kernel
registry (``ref`` for CPU tensors, the CUDA kernel
``csrc/bucket_logits.cu`` for CUDA tensors).

``core.lss.sparse_logits_bucketed`` (the unfused bucket-major forward)
sends its slab dots through this op.  No TPU lane padding (d and P to
128) is carried over: the kernel handles any d and P.

The kernel's launch plan (:func:`bucket_logits_plan`: how each (b, l)'s P
rows are split over blocks, the rows of a warp's bulk copy, shared
memory) is made here and passed to the kernel, which refuses one that
does not cover the rows or fit in a block.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bucket_logits.ref import bucket_logits_ref
from repro_torch.kernels.registry import kernel_op

__all__ = ["bucket_logits", "bucket_logits_cuda", "bucket_logits_op",
           "BucketLogitsPlan", "bucket_logits_plan", "bucket_logits_cost"]

bucket_logits_op = kernel_op("bucket_logits")
bucket_logits_op.register_impl("ref", bucket_logits_ref)

_FLOATS = (torch.float32, torch.bfloat16)

# the kernel's constants (csrc/bucket_logits.cu)
_WARPS = 8                  # warps of a block, at most
_STAGES = 2                 # chunks in a warp's ring
_CHUNK_BYTES = 4224         # slab bytes of one warp's bulk copy, at most
_ROWS_AT_ONCE = 8           # rows a warp dots together
# the plan's choices
_GROUP = 4                  # queries a block serves, at most
_BLOCKS_PER_SM = 2          # the grid it aims for, at least, per SM
_CHUNKS_PER_WARP = 2        # a block's rows: this many chunks a warp, at most,
_IDS_PER_ROW_BYTES = 32     # unless its slab ids exceed 1/32 of their bytes
_MAX_GROUP_IDS = 2048       # slab ids a block reads to group queries

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("bucket_logits")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.bucket_logits_launch.argtypes = [vp] * 4 + [i] * 15 + [vp]
        lib.bucket_logits_launch.restype = i
        lib.bucket_logits_error_string.argtypes = [i]
        lib.bucket_logits_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _align16(n: int) -> int:
    return (n + 15) & ~15


class BucketLogitsPlan(NamedTuple):
    rows: int          # slab rows of one chunk (a warp's bulk copy)
    stage: int         # bytes of one ring stage
    block_rows: int    # slab rows of one block
    splits: int        # blocks per (query, table)
    blocks: int        # the grid: B * L * splits
    warps: int         # warps of a block
    n_ids: int         # slab ids a block reads to group queries (0: none)
    group: int         # queries a block serves, at most
    smem: int          # dynamic shared memory of one block (bytes)


def bucket_logits_plan(bsz: int, n_tables: int, cap: int, d: int,
                       w_dtype: torch.dtype = torch.float32,
                       n_sms: int = _build.H100_SMS) -> BucketLogitsPlan:
    """How one launch spreads ``B * L`` slabs of ``cap`` rows over the card.

    Each (b, l)'s rows are split over ``splits`` blocks of ``block_rows``,
    so that the grid is at least ``2 * n_sms`` blocks where the rows allow
    (B = 1 spreads one slab over the SMs) and a block holds at most 2
    chunks a warp.  A chunk is at most ~4 KB of whole rows (a multiple of
    8 rows where 8 fit), fewer where the block has fewer rows than 8
    chunks.  For 2 <= B*L <= 2,048 every block reads the B*L slab ids, and
    the (b, l)s on one slab are served 4 at a time by one block each, which
    reads the slab's rows once for all 4; a block then reads at least 32
    bytes of rows for each byte of ids (K = 8, L = 4: 268 rows a block).

    Shared memory: for each warp 2 mbarriers and a ring of 2 stages (a
    chunk + 32 B: the copy is rounded out to 16 B at both ends), then the
    group's queries in fp32, the slab ids, the group's (b, l)s and 2
    counters.  Rows too wide for that give up the grouping, then warps."""
    row_bytes = d * w_dtype.itemsize
    rows_max = _CHUNK_BYTES // row_bytes if row_bytes else _CHUNK_BYTES
    rows_max = (rows_max - rows_max % _ROWS_AT_ONCE
                if rows_max >= _ROWS_AT_ONCE else max(rows_max, 1))
    n_bl = bsz * n_tables
    n_ids = n_bl if 2 <= n_bl <= _MAX_GROUP_IDS else 0
    group = _GROUP if n_ids else 1
    per = -(-n_bl * cap // (_BLOCKS_PER_SM * n_sms))
    per = max(1, min(per, _WARPS * _CHUNKS_PER_WARP * rows_max))
    splits = max(1, -(-cap // per))
    if n_ids:
        splits = max(1, min(splits, cap * row_bytes
                            // (_IDS_PER_ROW_BYTES * 4 * n_ids)))
    block_rows = max(1, -(-cap // splits))
    rows = min(rows_max, -(-block_rows // _WARPS))
    stage = _align16(rows * row_bytes) + 32
    ring = _STAGES * (8 + stage)                   # one warp's

    def rest(n_ids, group):       # everything but the rings
        return 4 * group * d + 4 * n_ids + 4 * group + 8

    if _WARPS * ring + rest(n_ids, group) > _build.SMEM_LIMIT_BYTES:
        n_ids, group = 0, 1
    warps = max(0, min(_WARPS, (_build.SMEM_LIMIT_BYTES - rest(n_ids, group))
                       // ring))
    return BucketLogitsPlan(rows, stage, block_rows, splits,
                            n_bl * splits if cap else 0, warps, n_ids, group,
                            warps * ring + rest(n_ids, group))


@bucket_logits_op.impl("cuda")
def bucket_logits_cuda(q: torch.Tensor, w_slabs: torch.Tensor,
                       slab_ids: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronise).
    Slab ids must lie in ``[0, S)``; the kernel gives NaN logits for an id
    outside it (checking on the host would synchronise)."""
    if q.dim() != 2 or w_slabs.dim() != 3 or slab_ids.dim() != 2 or \
            w_slabs.shape[2] != q.shape[1] or \
            slab_ids.shape[0] != q.shape[0]:
        raise ValueError(f"bucket_logits: q {tuple(q.shape)}, slabs "
                         f"{tuple(w_slabs.shape)} and slab ids "
                         f"{tuple(slab_ids.shape)} do not make "
                         f"[B,d] x [S,P,d] x [B,L]")
    for name, t, dtypes in (("q", q, _FLOATS), ("w_slabs", w_slabs, _FLOATS),
                            ("slab_ids", slab_ids, (torch.int32,))):
        if t.dtype not in dtypes or t.device != q.device or not t.is_cuda:
            raise ValueError(f"bucket_logits: {name} must be one of "
                             f"{dtypes} on a CUDA device with q, got "
                             f"{t.dtype} on {t.device}")
    bsz, d = q.shape
    n_slabs, cap, _ = w_slabs.shape
    n_tables = slab_ids.shape[1]
    plan = bucket_logits_plan(bsz, n_tables, cap, d, w_slabs.dtype,
                              _build.sm_count(q.device))
    if plan.warps < 1:
        raise ValueError(f"bucket_logits: a row of d={d} needs a ring of "
                         f"{_STAGES} x {plan.stage} B, more than the "
                         f"{_build.SMEM_LIMIT_BYTES} B an H100 block can use")
    if plan.blocks >= 2 ** 31:
        raise ValueError(f"bucket_logits: {plan.blocks} blocks, more than "
                         f"a grid holds")
    q, w_slabs = q.contiguous(), w_slabs.contiguous()
    slab_ids = slab_ids.contiguous()
    out = torch.empty((bsz, n_tables, cap), dtype=torch.float32,
                      device=q.device)
    lib = _library()
    err = lib.bucket_logits_launch(
        q.data_ptr(), w_slabs.data_ptr(), slab_ids.data_ptr(),
        out.data_ptr(), bsz, n_tables, n_slabs, cap, d,
        int(q.dtype == torch.bfloat16), int(w_slabs.dtype == torch.bfloat16),
        plan.rows, plan.stage, plan.block_rows, plan.splits, plan.warps,
        plan.n_ids, plan.group, plan.smem,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "bucket_logits", lib.bucket_logits_error_string)
    bucket_logits_cuda.launches += 1
    return out


bucket_logits_cuda.launches = 0


def _fake(q, w_slabs, slab_ids):
    return q.new_empty((q.shape[0], slab_ids.shape[1], w_slabs.shape[1]),
                       dtype=torch.float32)


def bucket_logits_cost(q, w_slabs, slab_ids):
    """Every (query, table)'s slab distinct (at most the S slabs), each
    read whole; q and the slab ids read, the logits written; 2 d flops a
    logit, in fp32."""
    bsz, d = q.shape
    n_slabs, cap, _ = w_slabs.shape
    n_tables = slab_ids.shape[1]
    n = min(bsz * n_tables, n_slabs)
    return ({"float32": 2.0 * bsz * n_tables * cap * d},
            float(n * cap * d * w_slabs.element_size()
                  + bsz * d * q.element_size() + 4 * bsz * n_tables
                  + 4 * bsz * n_tables * cap))


bucket_logits_op.define(
    "(Tensor q, Tensor w_slabs, Tensor slab_ids) -> Tensor",
    _fake, bucket_logits_cost)


def bucket_logits(q: torch.Tensor, w_slabs: torch.Tensor,
                  slab_ids: torch.Tensor, *, impl: str | None = None
                  ) -> torch.Tensor:
    """``[B,d] x [S,P,d] x int32 [B,L] -> [B,L,P]`` fp32 sparse logits.

    impl: ``ref`` | ``cuda`` | None (by the tensors' device; see
    ``repro_torch.kernels.registry``)."""
    return bucket_logits_op(q, w_slabs, slab_ids, impl=impl)
