"""Public op: the fused LSS retrieve -> score -> top-k, dispatched through
the kernel registry (``ref`` for CPU tensors, the CUDA kernel
``csrc/lss_topk.cu`` for CUDA tensors).

``core.lss.lss_forward`` sends every bucket-major forward through this op.
Two knobs shape a call, as in the JAX package: ``impl`` and the
``lss_topk.dedup`` strategy (resolved and logged here; the CUDA kernel
uses one algorithm for both choices, which give the same mask).  The slab
storage (``lss_topk.slab_dtype``) is the index's: this op takes whatever
format ``w_bucketed`` has, with ``w_scale`` iff it is int8.

The TPU's VMEM budget becomes a shared-memory layout here
(:func:`lss_topk_layout`, the twin of ``make_layout`` in the kernel): q,
q/|q|, theta and a ring of slab chunks live in a block's shared memory
where they fit (the narrow layout); at an LM head's width, where they do
not, the wide layout keeps one copy of q there and reads theta and the
slab rows from global memory.  The per-slot arrays (ids, logits, int8
scales, the dedup hash table) join them where everything fits in the
232,448 B an H100 block can use, and otherwise go to a per-query scratch
tensor that the wrapper allocates.  So every C and every width is
served.  No TPU padding (B to the query tile, d and P to 128 lanes) is
carried over.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lss_topk import dedup as dedup_mod
from repro_torch.kernels.lss_topk import slabs as slabs_mod
from repro_torch.kernels.lss_topk.ref import lss_topk_ref
from repro_torch.kernels.registry import kernel_op

__all__ = ["lss_topk", "lss_topk_cuda", "lss_topk_op", "LssTopkLayout",
           "lss_topk_layout", "lss_topk_smem_bytes", "lss_topk_scratch_bytes",
           "lss_topk_blocks_per_sm", "lss_topk_cost"]

lss_topk_op = kernel_op("lss_topk")
lss_topk_op.register_impl("ref", lss_topk_ref)

_STORAGE = {"fp32": 0, "bf16": 1, "int8": 2}

# the kernel's constants (csrc/lss_topk.cu)
_WARPS = 8
_ROWS_AT_ONCE = 8           # rows a warp dots together
_WARP_CHUNK_BYTES = 4224    # slab bytes of one warp's chunk
_WARP_STAGES = 2            # a warp's chunks in its ring
_MAX_CANDIDATES = 2 ** 28   # the hash table's int32 arithmetic

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("lss_topk")
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lss_topk_launch.argtypes = [vp] * 10 + [i] * 7 + [vp]
        lib.lss_topk_launch.restype = i
        for fn, res in (("lss_topk_smem_bytes", ll),
                        ("lss_topk_scratch_bytes", ll),
                        ("lss_topk_blocks_per_sm", i),
                        ("lss_topk_wide", i)):
            getattr(lib, fn).argtypes = [i] * 5
            getattr(lib, fn).restype = res
        lib.lss_topk_error_string.argtypes = [i]
        lib.lss_topk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _align16(n: int) -> int:
    return (n + 15) & ~15


class LssTopkLayout(NamedTuple):
    rows: int          # slab rows per chunk
    stage: int         # bytes of one ring stage
    hash: int          # dedup hash table entries (a power of two >= 2C)
    smem: int          # dynamic shared memory of one block
    scratch: int       # scratch bytes per query (0: all in shared memory)
    wide: bool = False  # theta and slab rows from global memory, no ring


def lss_topk_layout(d: int, k_bits: int, n_tables: int, cap: int,
                    slab_dtype: str = "fp32") -> LssTopkLayout:
    """One ``lss_topk`` block's memory (mirrors ``make_layout`` in
    ``csrc/lss_topk.cu``).

    Shared memory, narrow: for each of the 8 warps, 2 mbarriers and a
    ring of 2 stages (a stage holds one chunk, ~4 KB of slab rows, + 32 B:
    the kernel rounds each chunk's bulk copy out to 16 B at both ends);
    q, q/|q|, theta and a few small arrays.  Where those exceed
    ``SMEM_LIMIT_BYTES`` the layout is wide: q and the small arrays only,
    chunks of 8 rows read from global memory (``stage`` 0).  The per-slot
    arrays, C ids, C logits, C int8 scales and a hash table of ``hash``
    slot positions (load factor <= 0.5), join them if everything fits in
    ``SMEM_LIMIT_BYTES``; otherwise they are the per-query scratch."""
    c = n_tables * cap
    row_bytes = d * slabs_mod.slab_itemsize(slab_dtype)
    rows = _WARP_CHUNK_BYTES // row_bytes
    rows = rows - rows % _ROWS_AT_ONCE if rows >= _ROWS_AT_ONCE else max(rows, 1)
    stage = _align16(rows * row_bytes) + 32
    hash_entries = dedup_mod._ceil_pow2(2 * c)
    kl = k_bits * n_tables
    ring = _WARPS * _WARP_STAGES * (8 + stage)     # mbarriers + stages
    vec = _align16(4 * (2 * d + d * kl + 4 * _WARPS + 2 * n_tables + kl + 1))
    wide = ring + vec > _build.SMEM_LIMIT_BYTES
    if wide:
        rows, stage, ring = _ROWS_AT_ONCE, 0, 0
        vec = _align16(4 * (d + 4 * _WARPS + 2 * n_tables + kl + 1))
    slot = _align16(4 * c * (3 if slab_dtype == "int8" else 2)
                    + 4 * hash_entries)
    in_smem = ring + vec + slot <= _build.SMEM_LIMIT_BYTES
    return LssTopkLayout(rows, stage, hash_entries,
                         ring + vec + (slot if in_smem else 0),
                         0 if in_smem else slot, wide)


def lss_topk_smem_bytes(d: int, k_bits: int, n_tables: int, cap: int,
                        slab_dtype: str = "fp32") -> int:
    """Dynamic shared memory of one ``lss_topk`` block."""
    return lss_topk_layout(d, k_bits, n_tables, cap, slab_dtype).smem


def lss_topk_scratch_bytes(d: int, k_bits: int, n_tables: int, cap: int,
                           slab_dtype: str = "fp32") -> int:
    """Scratch bytes per query (0 when the per-slot arrays fit in shared
    memory)."""
    return lss_topk_layout(d, k_bits, n_tables, cap, slab_dtype).scratch


def lss_topk_blocks_per_sm(d: int, k_bits: int, n_tables: int, cap: int,
                           slab_dtype: str = "fp32") -> int:
    """Blocks of this shape that fit on one SM of the current card
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; builds the
    kernel)."""
    lib = _library()
    n = lib.lss_topk_blocks_per_sm(d, k_bits, n_tables, cap,
                                   _STORAGE[slab_dtype])
    _build.check(max(-n, 0), "lss_topk occupancy", lib.lss_topk_error_string)
    return n


@lss_topk_op.impl("cuda")
def lss_topk_cuda(q_aug: torch.Tensor, theta: torch.Tensor,
                  table_ids: torch.Tensor, w_bucketed: torch.Tensor, *,
                  top_k: int, dedup: str | None = None,
                  w_scale: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Launch the fused kernel on the current stream (no synchronise).
    ``dedup`` is accepted and not used: the kernel's hash-table dedup
    gives the mask of either strategy."""
    del dedup
    n_tables, n_buckets, cap = table_ids.shape
    k_bits = n_buckets.bit_length() - 1
    bsz, d = q_aug.shape
    c = n_tables * cap
    sdt = slabs_mod.slab_dtype_of(w_bucketed)
    if 2 ** k_bits != n_buckets or not 1 <= k_bits <= 30:
        raise ValueError(f"lss_topk: {n_buckets} buckets is not 2^K")
    if theta.shape != (d, k_bits * n_tables):
        raise ValueError(f"lss_topk: theta {tuple(theta.shape)} != "
                         f"({d}, {k_bits * n_tables})")
    if w_bucketed.shape != (n_tables, n_buckets, cap, d):
        raise ValueError(f"lss_topk: slabs {tuple(w_bucketed.shape)} != "
                         f"({n_tables}, {n_buckets}, {cap}, {d})")
    if not 1 <= top_k <= c:
        raise ValueError(f"lss_topk: top_k={top_k} outside 1..C={c}")
    if (sdt == "int8") != (w_scale is not None):
        raise ValueError("lss_topk: int8 slabs need w_scale, others forbid it")
    tensors = {"q_aug": (q_aug, torch.float32),
               "theta": (theta, torch.float32),
               "table_ids": (table_ids, torch.int32),
               "w_bucketed": (w_bucketed, w_bucketed.dtype),
               "w_scale": (w_scale, torch.float32)}
    for name, (t, dtype) in tensors.items():
        if t is not None and (t.dtype != dtype or t.device != q_aug.device):
            raise ValueError(f"lss_topk: {name} must be {dtype} on "
                             f"{q_aug.device}, got {t.dtype} on {t.device}")
    if c > _MAX_CANDIDATES:
        raise ValueError(f"lss_topk: C={c} candidates, more than the "
                         f"{_MAX_CANDIDATES} the kernel indexes")
    lay = lss_topk_layout(d, k_bits, n_tables, cap, sdt)
    if lay.smem > _build.SMEM_LIMIT_BYTES:
        raise ValueError(
            f"lss_topk: d={d}, K*L={k_bits * n_tables} needs {lay.smem} B of "
            f"shared memory for one copy of q, more than the "
            f"{_build.SMEM_LIMIT_BYTES} B an H100 block can use")
    q_aug, theta = q_aug.contiguous(), theta.contiguous()
    table_ids, w_bucketed = table_ids.contiguous(), w_bucketed.contiguous()
    scales = w_scale.contiguous() if w_scale is not None else None
    dev = q_aug.device
    top_logits = torch.empty((bsz, top_k), dtype=torch.float32, device=dev)
    top_ids = torch.empty((bsz, top_k), dtype=torch.int32, device=dev)
    sample = torch.empty((bsz,), dtype=torch.int32, device=dev)
    cand = torch.empty((bsz, c), dtype=torch.int32, device=dev)
    scratch = (torch.empty((bsz * lay.scratch,), dtype=torch.uint8,
                           device=dev) if lay.scratch else None)
    lib = _library()
    err = lib.lss_topk_launch(
        q_aug.data_ptr(), theta.data_ptr(), table_ids.data_ptr(),
        w_bucketed.data_ptr(), scales.data_ptr() if scales is not None else 0,
        top_logits.data_ptr(), top_ids.data_ptr(), sample.data_ptr(),
        cand.data_ptr(), scratch.data_ptr() if scratch is not None else 0,
        bsz, d, k_bits, n_tables, cap, top_k, _STORAGE[sdt],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lss_topk", lib.lss_topk_error_string)
    lss_topk_cuda.launches += 1
    return top_logits, top_ids, sample, cand


lss_topk_cuda.launches = 0


def _fake(q_aug, theta, table_ids, w_bucketed, *, top_k, dedup=None,
          w_scale=None):
    bsz = q_aug.shape[0]
    c = table_ids.shape[0] * table_ids.shape[2]
    return (q_aug.new_empty((bsz, top_k), dtype=torch.float32),
            q_aug.new_empty((bsz, top_k), dtype=torch.int32),
            q_aug.new_empty((bsz,), dtype=torch.int32),
            q_aug.new_empty((bsz, c), dtype=torch.int32))


def lss_topk_cost(q_aug, theta, table_ids, w_bucketed, *, top_k,
                  dedup=None, w_scale=None):
    """``chip_smoke.py``'s bound with every query's L slabs distinct (at
    most the L 2^K slabs) and every slot occupied: each such slab's P ids
    and P rows (+ an fp32 scale a row for int8) read once, the queries and
    theta read, the outputs written; 2 d fp32 flops a slot a query.  The
    data-aware bound never exceeds it."""
    n_tables, n_buckets, cap = table_ids.shape
    bsz, d = q_aug.shape
    c = n_tables * cap
    n = min(bsz * n_tables, n_tables * n_buckets)
    row = d * w_bucketed.element_size() + (4 if w_scale is not None else 0)
    nbytes = (n * cap * 4 + n * cap * row + 4 * bsz * d + 4 * theta.numel()
              + 4 * bsz * c + 8 * bsz * top_k + 4 * bsz)
    return {"float32": 2.0 * d * bsz * c}, float(nbytes)


lss_topk_op.define(
    "(Tensor q_aug, Tensor theta, Tensor table_ids, Tensor w_bucketed, *, "
    "int top_k, str? dedup=None, Tensor? w_scale=None) "
    "-> (Tensor, Tensor, Tensor, Tensor)", _fake, lss_topk_cost)


def lss_topk(q_aug: torch.Tensor, theta: torch.Tensor,
             table_ids: torch.Tensor, w_bucketed: torch.Tensor, *,
             top_k: int, impl: str | None = None, dedup: str | None = None,
             w_scale: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """Fused Algorithm-2 forward over a bucket-major index.

    ``[B,d] x [d,KL] x [L,2^K,P] x [L,2^K,P,d] ->``
    ``(top_logits [B,k], top_ids [B,k], sample_size [B], cand_ids [B,L*P])``

    impl:    ``ref`` | ``cuda`` | None (by the tensors' device).
    dedup:   ``quadratic`` | ``bitonic`` | None (auto on C = L*P).
    w_scale: fp32 ``[L, 2^K, P]`` row scales, iff the slabs are int8.
    """
    n_tables, _, capacity = table_ids.shape
    sdt = slabs_mod.slab_dtype_of(w_bucketed)
    if (sdt == "int8") != (w_scale is not None):
        raise ValueError(
            f"slab_dtype={sdt} storage and w_scale disagree: int8 slabs "
            f"require a per-neuron-row scale table, other formats forbid "
            f"one (got w_scale={'set' if w_scale is not None else 'None'})")
    choice = dedup_mod.resolve_dedup(dedup, n_candidates=n_tables * capacity)
    return lss_topk_op(q_aug, theta, table_ids, w_bucketed, top_k=top_k,
                       dedup=choice, w_scale=w_scale, impl=impl)
