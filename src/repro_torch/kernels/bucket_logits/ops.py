"""Public op: bucket-major sparse WOL logits, dispatched through the kernel
registry (``ref`` for CPU tensors, the CUDA kernel
``csrc/bucket_logits.cu`` for CUDA tensors).

``core.lss.sparse_logits_bucketed`` (the unfused bucket-major forward)
sends its slab dots through this op.  No TPU lane padding (d and P to
128) is carried over: the kernel handles any d and P.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bucket_logits.ref import bucket_logits_ref
from repro_torch.kernels.registry import kernel_op

__all__ = ["bucket_logits", "bucket_logits_cuda", "bucket_logits_op"]

bucket_logits_op = kernel_op("bucket_logits")
bucket_logits_op.register_impl("ref", bucket_logits_ref)

_FLOATS = (torch.float32, torch.bfloat16)

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("bucket_logits")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.bucket_logits_launch.argtypes = [vp] * 4 + [i] * 7 + [vp]
        lib.bucket_logits_launch.restype = i
        lib.bucket_logits_error_string.argtypes = [i]
        lib.bucket_logits_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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
    q, w_slabs = q.contiguous(), w_slabs.contiguous()
    slab_ids = slab_ids.contiguous()
    out = torch.empty((bsz, n_tables, cap), dtype=torch.float32,
                      device=q.device)
    lib = _library()
    err = lib.bucket_logits_launch(
        q.data_ptr(), w_slabs.data_ptr(), slab_ids.data_ptr(),
        out.data_ptr(), bsz, n_tables, n_slabs, cap, d,
        int(q.dtype == torch.bfloat16), int(w_slabs.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "bucket_logits", lib.bucket_logits_error_string)
    bucket_logits_cuda.launches += 1
    return out


bucket_logits_cuda.launches = 0


def bucket_logits(q: torch.Tensor, w_slabs: torch.Tensor,
                  slab_ids: torch.Tensor, *, impl: str | None = None
                  ) -> torch.Tensor:
    """``[B,d] x [S,P,d] x int32 [B,L] -> [B,L,P]`` fp32 sparse logits.

    impl: ``ref`` | ``cuda`` | None (by the tensors' device; see
    ``repro_torch.kernels.registry``)."""
    return bucket_logits_op(q, w_slabs, slab_ids, impl=impl)
