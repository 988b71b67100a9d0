"""Public op: one layer's causal prefill attention, dispatched through the
kernel registry (``ref`` for CPU tensors, the CUDA kernel
``csrc/prefill_attention.cu`` for CUDA tensors).

The transformer's prefill (``models.transformer``, ``mode="prefill"``,
plain tensors) sends each layer's attention here; training and the mesh
keep ``layers.attention_blockwise``.  ``kv_chunk`` and ``q_chunk`` are the
model's chunks: the plain version loops over them, so a CPU prefill keeps
its bits; the kernel tiles at its own 64 positions and takes any S.

The kernel takes float32 or bfloat16 (one type for q, k and v), head sizes
16, 64 and 128, and up to 16 query heads a KV head; any other shape, type
or layout raises here.  It has no backward: prefill is inference.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prefill_attention.ref import prefill_attention_ref
from repro_torch.kernels.registry import kernel_op

__all__ = ["prefill_attention", "prefill_attention_cuda",
           "prefill_attention_op", "prefill_attention_cost"]

prefill_attention_op = kernel_op("prefill_attention")
prefill_attention_op.register_impl("ref", prefill_attention_ref)

# the kernel's constants (csrc/prefill_attention.cu)
HEAD_DIMS = (16, 64, 128)
MAX_GROUP = 16              # query heads a KV head serves, at most
TILE = 64                   # query rows a block, positions a KV tile
MAX_TILES = 65535           # query tiles: the grid's second axis
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("prefill_attention")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.prefill_attention_launch.argtypes = ([vp] * 4 + [i] * 6
                                                 + [ctypes.c_float, vp])
        lib.prefill_attention_launch.restype = i
        lib.prefill_attention_error_string.argtypes = [i]
        lib.prefill_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_args(q, k, v) -> None:
    """Raise ``ValueError`` on what the kernel does not take: shapes that
    do not fit together, a type other than float32 or bfloat16 (one for q,
    k and v), a head size outside ``HEAD_DIMS``, a ratio N / KV that is not
    whole or above ``MAX_GROUP``, more than ``MAX_TILES`` query tiles, a
    tensor that is not contiguous or not 16-byte aligned (the kernel copies
    16 bytes at a time), an input that would want a gradient (the kernel
    has no backward: its output would be cut from the graph)."""
    name = "prefill_attention"
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} are not [B, S, N, H], [B, S, KV, H]")
    b, s, n, h = q.shape
    kv = k.shape[2]
    if v.shape != k.shape or k.shape != (b, s, kv, h):
        raise ValueError(
            f"{name}: shapes do not fit: q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"{name}: q, k and v must share one dtype of {tuple(_DTYPES)}, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if h not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {h} is not one of {HEAD_DIMS}")
    if kv == 0 or n % kv or n // kv > MAX_GROUP:
        raise ValueError(f"{name}: {n} query heads over {kv} KV heads: the "
                         f"ratio must be whole and at most {MAX_GROUP}")
    if b == 0 or not 1 <= -(-s // TILE) <= MAX_TILES:
        raise ValueError(f"{name}: batch {b}, sequence {s}: the kernel "
                         f"takes 1 to {MAX_TILES * TILE} positions a row")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must be 16-byte aligned")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError(f"{name}: the kernel has no backward; q, k and v "
                         f"require grad (run the prefill under no_grad)")


@prefill_attention_op.impl("cuda")
def prefill_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_chunk: int, q_chunk: int | None
                           ) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronise); the
    chunks are the plain version's and unused here."""
    _check_args(q, k, v)
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("prefill_attention: every input must be a CUDA "
                         "tensor on one device")
    b, s, n, h = q.shape
    out = torch.empty_like(q)
    lib = _library()
    err = lib.prefill_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, s, n, k.shape[2], h, h ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "prefill_attention",
                 lib.prefill_attention_error_string)
    prefill_attention_cuda.launches += 1
    return out


prefill_attention_cuda.launches = 0


def _fake(q, k, v, kv_chunk, q_chunk):
    return q.new_empty(q.shape)


def prefill_attention_cost(q, k, v, kv_chunk, q_chunk):
    """The causal half: q.k and p.v over the S(S+1)/2 (query, key) pairs
    at or below the diagonal, 4 * N * H operations a pair, in q's type; q,
    k and v read once, the output written once."""
    b, s, n, h = q.shape
    flops = 4.0 * b * n * h * s * (s + 1) / 2
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return {str(q.dtype).removeprefix("torch."): flops}, float(nbytes)


prefill_attention_op.define(
    "(Tensor q, Tensor k, Tensor v, int kv_chunk, int? q_chunk) -> Tensor",
    _fake, prefill_attention_cost)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_chunk: int, q_chunk: int | None, *,
                      impl: str | None = None) -> torch.Tensor:
    """Causal attention of a prompt: q ``[B, S, N, H]`` against k, v
    ``[B, S, KV, H]`` (position i sees positions 0..i) -> ``[B, S, N, H]``
    in q's type.

    impl: ``ref`` | ``cuda`` | None (by the tensors' device; see
    ``repro_torch.kernels.registry``)."""
    return prefill_attention_op(q, k, v, kv_chunk, q_chunk, impl=impl)
