"""Public op: simhash bucket codes, dispatched through the kernel registry
(``ref`` for CPU tensors, the CUDA kernel ``csrc/simhash_codes.cu`` for
CUDA tensors)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.registry import kernel_op
from repro_torch.kernels.simhash_codes.ref import simhash_codes_ref

__all__ = ["simhash_codes", "simhash_codes_cuda", "simhash_codes_op"]

simhash_codes_op = kernel_op("simhash_codes")
simhash_codes_op.register_impl("ref", simhash_codes_ref)

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("simhash_codes")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.simhash_codes_launch.argtypes = [vp, vp, vp, i, i, i, i, vp]
        lib.simhash_codes_launch.restype = i
        lib.simhash_codes_error_string.argtypes = [i]
        lib.simhash_codes_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@simhash_codes_op.impl("cuda")
def simhash_codes_cuda(x: torch.Tensor, theta: torch.Tensor, k_bits: int,
                       n_tables: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronise)."""
    if x.dim() != 2 or theta.dim() != 2 or theta.shape != (
            x.shape[1], k_bits * n_tables):
        raise ValueError(f"simhash_codes: x {tuple(x.shape)} and theta "
                         f"{tuple(theta.shape)} do not make [B,d] x "
                         f"[d,{k_bits}*{n_tables}]")
    if not 1 <= k_bits <= 30:
        raise ValueError(f"simhash_codes: k_bits={k_bits} is outside 1..30")
    for name, t in (("x", x), ("theta", theta)):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"simhash_codes: {name} must be a float32 CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
    x, theta = x.contiguous(), theta.contiguous()
    out = torch.empty((x.shape[0], n_tables), dtype=torch.int32,
                      device=x.device)
    lib = _library()
    err = lib.simhash_codes_launch(
        x.data_ptr(), theta.data_ptr(), out.data_ptr(), x.shape[0],
        x.shape[1], k_bits, n_tables,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "simhash_codes", lib.simhash_codes_error_string)
    simhash_codes_cuda.launches += 1
    return out


simhash_codes_cuda.launches = 0


def simhash_codes(x: torch.Tensor, theta: torch.Tensor, k_bits: int,
                  n_tables: int, *, impl: str | None = None) -> torch.Tensor:
    """``[B, d] x [d, K*L] -> int32 bucket ids [B, L]``.

    impl: ``ref`` | ``cuda`` | None (by the tensors' device; see
    ``repro_torch.kernels.registry``)."""
    return simhash_codes_op(x, theta, k_bits, n_tables, impl=impl)
