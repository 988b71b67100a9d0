"""Public op: simhash bucket codes, dispatched through the kernel registry
(``ref`` for CPU tensors, the CUDA kernel ``csrc/simhash_codes.cu`` for
CUDA tensors).

The kernel's launch plan (:func:`simhash_codes_plan`: rows per block,
theta's padded row stride, the d-tile, shared memory) is made here and
passed to the kernel, which refuses one that does not fit the shapes.
Where theta and a block's rows fit in shared memory whole, they go there
in one piece; at a wider d (an LM head's d_model + 1) they are fed in
d-tiles, so every width is served.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.registry import kernel_op
from repro_torch.kernels.simhash_codes.ref import simhash_codes_ref

__all__ = ["simhash_codes", "simhash_codes_cuda", "simhash_codes_op",
           "SimhashCodesPlan", "simhash_codes_plan", "simhash_codes_cost"]

simhash_codes_op = kernel_op("simhash_codes")
simhash_codes_op.register_impl("ref", simhash_codes_ref)

_MAX_ROWS = 8      # rows per block, at most (kMaxRows in the kernel)
_MAX_TILE = 1024   # d-tile, at most: a few blocks an SM, not one

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("simhash_codes")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.simhash_codes_launch.argtypes = [vp, vp, vp] + [i] * 8 + [vp]
        lib.simhash_codes_launch.restype = i
        lib.simhash_codes_error_string.argtypes = [i]
        lib.simhash_codes_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


class SimhashCodesPlan(NamedTuple):
    rows: int       # rows of x per block
    blocks: int     # the grid: ceil(B / rows)
    stride: int     # theta's row stride in shared memory: K*L, made odd
    smem: int       # dynamic shared memory of one block (bytes)
    tile: int = 0   # d-tile (a multiple of 32); 0: theta and rows whole


def simhash_codes_plan(bsz: int, d: int, k_bits: int, n_tables: int,
                       n_sms: int = _build.H100_SMS) -> SimhashCodesPlan:
    """One launch of the kernel: as many rows a block as keep the grid at
    least ``n_sms`` blocks (at most 8), theta's rows padded to an odd
    stride (so a column's 32 reads hit 32 banks), theta and the rows in
    shared memory; where they do not fit whole, in d-tiles of at most
    1,024 elements, a multiple of 32 (each lane then sums in the same
    order)."""
    rows = max(1, min(_MAX_ROWS, bsz // n_sms))
    stride = k_bits * n_tables | 1
    whole = 4 * (d * stride + rows * d)
    if whole <= _build.SMEM_LIMIT_BYTES:
        return SimhashCodesPlan(rows, -(-bsz // rows), stride, whole)
    tile = min(_MAX_TILE,
               _build.SMEM_LIMIT_BYTES // (4 * (stride + rows)) // 32 * 32)
    if tile < 32:
        raise ValueError(f"simhash_codes: K*L={k_bits * n_tables} "
                         f"hyperplanes leave no 32-element d-tile within "
                         f"the {_build.SMEM_LIMIT_BYTES} B an H100 block "
                         f"can use")
    return SimhashCodesPlan(rows, -(-bsz // rows), stride,
                            4 * (tile * stride + rows * tile), tile)


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
    bsz, d = x.shape
    plan = simhash_codes_plan(bsz, d, k_bits, n_tables,
                              _build.sm_count(x.device))
    x, theta = x.contiguous(), theta.contiguous()
    out = torch.empty((bsz, n_tables), dtype=torch.int32, device=x.device)
    lib = _library()
    err = lib.simhash_codes_launch(
        x.data_ptr(), theta.data_ptr(), out.data_ptr(), bsz, d, k_bits,
        n_tables, plan.rows, plan.stride, plan.tile, plan.smem,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "simhash_codes", lib.simhash_codes_error_string)
    simhash_codes_cuda.launches += 1
    return out


simhash_codes_cuda.launches = 0


def _fake(x, theta, k_bits, n_tables):
    return x.new_empty((x.shape[0], n_tables), dtype=torch.int32)


def simhash_codes_cost(x, theta, k_bits, n_tables):
    """``[B, d] x [d, K*L]`` in fp32: x, theta read, the codes written."""
    bsz, d = x.shape
    kl = k_bits * n_tables
    return ({"float32": 2.0 * bsz * d * kl},
            4.0 * (bsz * d + d * kl + bsz * n_tables))


simhash_codes_op.define(
    "(Tensor x, Tensor theta, int k_bits, int n_tables) -> Tensor",
    _fake, simhash_codes_cost)


def simhash_codes(x: torch.Tensor, theta: torch.Tensor, k_bits: int,
                  n_tables: int, *, impl: str | None = None) -> torch.Tensor:
    """``[B, d] x [d, K*L] -> int32 bucket ids [B, L]``.

    impl: ``ref`` | ``cuda`` | None (by the tensors' device; see
    ``repro_torch.kernels.registry``)."""
    return simhash_codes_op(x, theta, k_bits, n_tables, impl=impl)
