"""Public op: one decode step's attention over a paged KV cache,
dispatched through the kernel registry (``ref`` for CPU tensors, the CUDA
kernel ``csrc/decode_attention.cu`` for CUDA tensors).

Every decode step of the transformer (``models.transformer``: dense
slabs, the dense pool and the paged pool alike) sends each layer's
attention here.  A dense slab ``[B, S, KV, H]`` is an arena of one
``S``-token page a row (table ``[[0], [1], ...]``), so both layouts run
the same kernel and a row's result depends on its own data only.  The
op also writes the step's new K and V row into the arenas, in place, at
``lengths`` (a row at ``lengths == max_len`` writes nothing).

The kernel's choices follow from its inputs' shapes: the type and head
size (16, 64 or 128) pick the split (the positions a block covers, which
the library reports) and, with the query heads a KV head serves
(r = N / KV, up to 16), the instantiation; any other shape, type or
layout raises here.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.registry import kernel_op

__all__ = ["decode_attention", "decode_attention_cuda", "decode_attention_op",
           "decode_attention_cost"]

decode_attention_op = kernel_op("decode_attention")
decode_attention_op.register_impl("ref", decode_attention_ref)

# the kernel's constants (csrc/decode_attention.cu)
HEAD_DIMS = (16, 64, 128)
MAX_GROUP = 16              # query heads a KV head serves, at most
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("decode_attention")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = ([vp] * 10 + [i] * 8
                                                + [ctypes.c_float, vp])
        lib.decode_attention_launch.restype = i
        lib.decode_attention_error_string.argtypes = [i]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib.decode_attention_split_positions.argtypes = [i, i]
        lib.decode_attention_split_positions.restype = i
        _lib = lib
    return _lib


def _check_args(q, k_arena, v_arena, page_table, lengths, k_new, v_new,
               max_len) -> None:
    """Raise ``ValueError`` on what the kernel does not take: shapes that
    do not fit together, a type other than float32 or bfloat16 (one for
    q, the arenas and the new rows), int32 table and lengths, a head size
    outside ``HEAD_DIMS``, a ratio N / KV that is not whole or above
    ``MAX_GROUP``, a ``max_len`` the table cannot hold, a tensor that is
    not contiguous, a float tensor not 16-byte aligned (the kernel reads
    and copies 16 bytes at a time)."""
    name = "decode_attention"
    if (q.dim() != 3 or k_arena.dim() != 4 or page_table.dim() != 2
            or lengths.dim() != 1 or k_new.dim() != 3):
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, arenas {tuple(k_arena.shape)}, "
            f"table {tuple(page_table.shape)}, lengths "
            f"{tuple(lengths.shape)}, new rows {tuple(k_new.shape)} are not "
            f"[B, N, H], [n_pages, page_tokens, KV, H], [B, pages], [B], "
            f"[B, KV, H]")
    b, n, h = q.shape
    _, p, kv, hk = k_arena.shape
    if (v_arena.shape != k_arena.shape or hk != h or page_table.shape[0] != b
            or lengths.shape != (b,) or k_new.shape != (b, kv, h)
            or v_new.shape != k_new.shape):
        raise ValueError(
            f"{name}: shapes do not fit: q {tuple(q.shape)}, arenas "
            f"{tuple(k_arena.shape)} / {tuple(v_arena.shape)}, table "
            f"{tuple(page_table.shape)}, lengths {tuple(lengths.shape)}, "
            f"new rows {tuple(k_new.shape)} / {tuple(v_new.shape)}")
    if q.dtype not in _DTYPES or any(
            t.dtype != q.dtype for t in (k_arena, v_arena, k_new, v_new)):
        raise ValueError(
            f"{name}: q, the arenas and the new rows must share one dtype "
            f"of {tuple(_DTYPES)}, got {q.dtype}, {k_arena.dtype}, "
            f"{v_arena.dtype}, {k_new.dtype}, {v_new.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: table and lengths must be int32, got "
                         f"{page_table.dtype}, {lengths.dtype}")
    if h not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {h} is not one of {HEAD_DIMS}")
    if n % kv or n // kv > MAX_GROUP:
        raise ValueError(f"{name}: {n} query heads over {kv} KV heads: the "
                         f"ratio must be whole and at most {MAX_GROUP}")
    if not 1 <= max_len <= p * page_table.shape[1]:
        raise ValueError(f"{name}: max_len {max_len} is outside 1.."
                         f"{p * page_table.shape[1]} (the table's pages)")
    tensors = (q, k_arena, v_arena, page_table, lengths, k_new, v_new)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every input must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_arena, v_arena, k_new, v_new)):
        raise ValueError(f"{name}: q, the arenas and the new rows must be "
                         f"16-byte aligned")


@decode_attention_op.impl("cuda")
def decode_attention_cuda(q: torch.Tensor, k_arena: torch.Tensor,
                          v_arena: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, max_len: int) -> torch.Tensor:
    """Launch the CUDA kernels on the current stream (no synchronise)."""
    _check_args(q, k_arena, v_arena, page_table, lengths, k_new, v_new,
                max_len)
    tensors = (q, k_arena, v_arena, page_table, lengths, k_new, v_new)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("decode_attention: every input must be a CUDA "
                         "tensor on one device")
    b, n, h = q.shape
    _, p, kv, _ = k_arena.shape
    lib = _library()
    # a block's split: a 32 KB tile of K (and one of V), at most 256
    # positions; its bounds are absolute positions
    split = lib.decode_attention_split_positions(_DTYPES[q.dtype], h)
    n_splits = -(-max_len // split)
    ws_acc = torch.empty((b, n, n_splits, h), dtype=torch.float32,
                         device=q.device)
    ws_ml = torch.empty((b, n, n_splits, 2), dtype=torch.float32,
                        device=q.device)
    out = torch.empty_like(q)
    err = lib.decode_attention_launch(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), ws_acc.data_ptr(), ws_ml.data_ptr(),
        out.data_ptr(), _DTYPES[q.dtype], b, n, kv, h, p,
        page_table.shape[1], max_len, h ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention", lib.decode_attention_error_string)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0


def _fake(q, k_arena, v_arena, page_table, lengths, k_new, v_new, max_len):
    return q.new_empty(q.shape)


def decode_attention_cost(q, k_arena, v_arena, page_table, lengths, k_new,
                          v_new, max_len):
    """At the most the shapes allow (every row attends over ``max_len``
    positions): q.k and p.v, 4 * N * H fp32 operations a position; K and
    V of ``max_len`` positions a row read, q read, the output written,
    the new rows read and written, the table and lengths read."""
    b, n, h = q.shape
    kv = k_arena.shape[2]
    isz = k_arena.element_size()
    nbytes = (2 * b * max_len * kv * h * isz + 2 * b * n * h * q.element_size()
              + 4 * b * kv * h * isz + page_table.numel() * 4 + b * 4)
    return {"float32": 4.0 * b * n * h * max_len}, float(nbytes)


decode_attention_op.define(
    "(Tensor q, Tensor(a!) k_arena, Tensor(b!) v_arena, Tensor page_table, "
    "Tensor lengths, Tensor k_new, Tensor v_new, int max_len) -> Tensor",
    _fake, decode_attention_cost)


def decode_attention(q: torch.Tensor, k_arena: torch.Tensor,
                     v_arena: torch.Tensor, page_table: torch.Tensor,
                     lengths: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, max_len: int, *,
                     impl: str | None = None) -> torch.Tensor:
    """One decode step's attention over a paged KV cache: q ``[B, N, H]``
    against positions ``0..min(lengths, max_len - 1)`` of each row (its
    pages through ``page_table`` ``[B, pages_per_slot]``, its own
    position ``lengths`` from ``k_new``, ``v_new`` ``[B, KV, H]``, which
    are written there) -> ``[B, N, H]`` in q's type.

    impl: ``ref`` | ``cuda`` | None (by the tensors' device; see
    ``repro_torch.kernels.registry``)."""
    return decode_attention_op(q, k_arena, v_arena, page_table, lengths,
                               k_new, v_new, max_len, impl=impl)
