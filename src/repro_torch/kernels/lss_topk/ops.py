"""Public op: the fused LSS retrieve -> score -> top-k, dispatched through
the kernel registry (``ref`` for CPU tensors, the CUDA kernel
``csrc/lss_topk.cu`` for CUDA tensors).

``core.lss.lss_forward`` sends every bucket-major forward through this op.
Two knobs shape a call, as in the JAX package: ``impl`` and the
``lss_topk.dedup`` strategy (resolved and logged here; the CUDA kernel
uses one algorithm for both choices, which give the same mask).  The slab
storage (``lss_topk.slab_dtype``) is the index's: this op takes whatever
format ``w_bucketed`` has, with ``w_scale`` iff it is int8.

The TPU's VMEM budget warning becomes a hard limit here:
:func:`lss_topk_smem_bytes` is the dynamic shared memory one block needs
(q, q/|q|, theta, and the C ids, logits and sort keys), and a launch that
needs more than the 232,448 B an H100 block can use raises.  No TPU
padding (B to the query tile, d and P to 128 lanes) is carried over.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lss_topk import dedup as dedup_mod
from repro_torch.kernels.lss_topk import slabs as slabs_mod
from repro_torch.kernels.lss_topk.ref import lss_topk_ref
from repro_torch.kernels.registry import kernel_op

__all__ = ["lss_topk", "lss_topk_cuda", "lss_topk_op",
           "lss_topk_smem_bytes"]

lss_topk_op = kernel_op("lss_topk")
lss_topk_op.register_impl("ref", lss_topk_ref)

_STORAGE = {"fp32": 0, "bf16": 1, "int8": 2}

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("lss_topk")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.lss_topk_launch.argtypes = [vp] * 9 + [i] * 7 + [vp]
        lib.lss_topk_launch.restype = i
        lib.lss_topk_smem_bytes.argtypes = [i, i, i, i]
        lib.lss_topk_smem_bytes.restype = i
        lib.lss_topk_error_string.argtypes = [i]
        lib.lss_topk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def lss_topk_smem_bytes(d: int, k_bits: int, n_tables: int, cap: int) -> int:
    """Dynamic shared memory of one ``lss_topk`` block (mirrors
    ``smem_bytes`` in ``csrc/lss_topk.cu``): 8-byte sort keys for the next
    power of two above C, q and q/|q|, theta, C logits and C ids, and a
    little reduction scratch."""
    c = n_tables * cap
    keys = 8 * dedup_mod._ceil_pow2(c)
    return keys + 4 * (2 * d + d * k_bits * n_tables + 2 * c + 64 + n_tables + 1)


@lss_topk_op.impl("cuda")
def lss_topk_cuda(q_aug: torch.Tensor, theta: torch.Tensor,
                  table_ids: torch.Tensor, w_bucketed: torch.Tensor, *,
                  top_k: int, dedup: str | None = None,
                  w_scale: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Launch the fused kernel on the current stream (no synchronise).
    ``dedup`` is accepted and not used: the kernel's bitonic sort gives the
    mask of either strategy."""
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
    smem = lss_topk_smem_bytes(d, k_bits, n_tables, cap)
    if smem > _build.SMEM_LIMIT_BYTES:
        raise ValueError(
            f"lss_topk: C={c}, d={d}, K*L={k_bits * n_tables} needs {smem} B "
            f"of shared memory, more than the {_build.SMEM_LIMIT_BYTES} B an "
            f"H100 block can use; reduce the capacity, K or L")
    q_aug, theta = q_aug.contiguous(), theta.contiguous()
    table_ids, w_bucketed = table_ids.contiguous(), w_bucketed.contiguous()
    scales = w_scale.contiguous() if w_scale is not None else None
    dev = q_aug.device
    top_logits = torch.empty((bsz, top_k), dtype=torch.float32, device=dev)
    top_ids = torch.empty((bsz, top_k), dtype=torch.int32, device=dev)
    sample = torch.empty((bsz,), dtype=torch.int32, device=dev)
    cand = torch.empty((bsz, c), dtype=torch.int32, device=dev)
    lib = _library()
    err = lib.lss_topk_launch(
        q_aug.data_ptr(), theta.data_ptr(), table_ids.data_ptr(),
        w_bucketed.data_ptr(), scales.data_ptr() if scales is not None else 0,
        top_logits.data_ptr(), top_ids.data_ptr(), sample.data_ptr(),
        cand.data_ptr(), bsz, d, k_bits, n_tables, cap, top_k,
        _STORAGE[sdt], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lss_topk", lib.lss_topk_error_string)
    lss_topk_cuda.launches += 1
    return top_logits, top_ids, sample, cand


lss_topk_cuda.launches = 0


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
