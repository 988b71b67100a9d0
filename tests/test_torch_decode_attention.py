"""The decode-attention op on the CPU: its plain version against the
paged decode step's former composition (each row's pages gathered to
``max_len``, the step's row written into the view, ``attention_decode``,
the row scattered back), bit for bit; a dense slab as an arena of one
page a row; the CUDA wrapper's checks, which run before any launch; the
op's registration.  The kernel itself is held against the plain version
on the card (``test_torch_cuda_kernels.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention_cuda)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

N_HEADS, KV_HEADS, HEAD_DIM = 14, 2, 64
MAX_LEN = 300                  # not a multiple of any page size below


def _paged_case(page, case, seed=0):
    """A shuffled arena holding 5 rows' pages, stale bits everywhere
    else, and each row's length; ``case`` adds the row it names."""
    rng = np.random.default_rng(seed)
    n_pp = -(-MAX_LEN // page)
    lengths = [int(x) for x in rng.integers(1, MAX_LEN, 5)]   # ragged
    if case == "full":
        lengths[1] = MAX_LEN
    elif case == "parked":
        lengths[2] = 0
    elif case == "crossing":
        lengths[3] = page if page < MAX_LEN else MAX_LEN - 1
        lengths[4] = 2 * page - 1 if 2 * page <= MAX_LEN else page - 1
    b = len(lengths)
    n_pages = 1 + b * n_pp
    table = 1 + rng.permutation(b * n_pp).reshape(b, n_pp)
    if case == "parked":
        table[2] = 0                          # scratch page 0 only
    for i, n in enumerate(lengths):           # unmapped past the write page
        table[i, min(n, MAX_LEN - 1) // page + 1:] = 0

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    return dict(
        q=bf16(b, N_HEADS, HEAD_DIM),
        k_arena=bf16(n_pages, page, KV_HEADS, HEAD_DIM),
        v_arena=bf16(n_pages, page, KV_HEADS, HEAD_DIM),
        page_table=torch.from_numpy(table.astype(np.int32)),
        lengths=torch.tensor(lengths, dtype=torch.int32),
        k_new=bf16(b, KV_HEADS, HEAD_DIM), v_new=bf16(b, KV_HEADS, HEAD_DIM),
        max_len=MAX_LEN)


def _gathered(q, k_arena, v_arena, page_table, lengths, k_new, v_new,
              max_len):
    """The paged step's attention as ``decode_step_paged`` composed it
    before the op: arenas gathered a layer at a time, the view written by
    ``_write_cache``, ``attention_decode``, then the view's row scattered
    to the write page (scratch page 0 for a row at ``max_len``)."""
    b, n_pp = page_table.shape
    _, p, n_kv, h = k_arena.shape
    table, lengths = page_table.long(), lengths.long()
    rows = torch.arange(b)
    wpos = lengths.clamp(0, max_len - 1)
    pidx = (lengths // p).clamp(0, n_pp - 1)
    dest = torch.where(lengths < max_len, table[rows, pidx], 0)
    off = torch.where(lengths < max_len, lengths % p, 0)

    def view(arena):
        return arena[table].reshape(b, n_pp * p, n_kv, h)[
            :, :max_len].contiguous()

    kv = T._write_cache(view(k_arena), k_new[:, None], lengths)
    vv = T._write_cache(view(v_arena), v_new[:, None], lengths)
    out = L.attention_decode(q[:, None], kv, vv, lengths + 1)[:, 0]
    k_arena[dest, off] = kv[rows, wpos]
    v_arena[dest, off] = vv[rows, wpos]
    return out


@pytest.mark.parametrize("case", ["ragged", "full", "parked", "crossing"])
@pytest.mark.parametrize("page", [4, 16, 128])
def test_plain_version_is_the_gathered_view_bit_for_bit(page, case):
    args = _paged_case(page, case)
    before = args["k_arena"].clone()
    mine = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in args.items()}
    want = _gathered(**args)
    got = decode_attention(**mine)
    assert registry.last_dispatch("decode_attention") == "ref"
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    # every real page as the former scatter left it (scratch page 0 took
    # the former's writes of rows that must not write)
    for side in ("k_arena", "v_arena"):
        assert torch.equal(mine[side][1:], args[side][1:]), side
    lengths, table = args["lengths"].long(), args["page_table"].long()
    p = args["k_arena"].shape[1]
    for i, n in enumerate(lengths.tolist()):
        if n < MAX_LEN:                 # the step's row at its write page
            page_id = int(table[i, n // p])
            assert torch.equal(mine["k_arena"][page_id, n % p],
                               args["k_new"][i])
    if case == "full":                  # the full row's pages keep their bits
        pages = table[1][table[1] > 0]
        assert torch.equal(mine["k_arena"][pages], before[pages])


def test_dense_slab_is_an_arena_of_one_page_a_row():
    """A ``[B, S, KV, H]`` slab read through the table ``[[0], [1], ...]``
    gives the bits ``attention_decode`` gives over the slab written in
    place by ``_write_cache``, and the slab's bits after the write."""
    rng = np.random.default_rng(3)
    b, s = 6, 40
    slab = torch.from_numpy(rng.standard_normal(
        (2, b, s, KV_HEADS, HEAD_DIM)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal(
        (b, 1, N_HEADS, HEAD_DIM)).astype(np.float32))
    k_new = torch.from_numpy(rng.standard_normal(
        (b, 1, KV_HEADS, HEAD_DIM)).astype(np.float32))
    lengths = torch.tensor([0, 1, 17, 38, 39, 40], dtype=torch.int32)
    want_k, want_v = slab[0].clone(), slab[1].clone()
    T._write_cache(want_k, k_new, lengths.long())
    T._write_cache(want_v, -k_new, lengths.long())
    want = L.attention_decode(q, want_k, want_v, lengths.long() + 1)
    kv = T._dense_kv(slab[:1], slab[1:], lengths)(0)
    assert kv.max_len == s and kv.table[:, 0].tolist() == list(range(b))
    got = decode_attention(q[:, 0], kv.k, kv.v, kv.table, kv.lengths,
                           k_new[:, 0], -k_new[:, 0], kv.max_len)
    assert torch.equal(got, want[:, 0])
    assert torch.equal(slab[0], want_k) and torch.equal(slab[1], want_v)


def _good():
    b, n_pages, page = 3, 7, 16
    return dict(
        q=torch.zeros(b, N_HEADS, HEAD_DIM, dtype=torch.bfloat16),
        k_arena=torch.zeros(n_pages, page, KV_HEADS, HEAD_DIM,
                            dtype=torch.bfloat16),
        v_arena=torch.zeros(n_pages, page, KV_HEADS, HEAD_DIM,
                            dtype=torch.bfloat16),
        page_table=torch.zeros(b, 2, dtype=torch.int32),
        lengths=torch.zeros(b, dtype=torch.int32),
        k_new=torch.zeros(b, KV_HEADS, HEAD_DIM, dtype=torch.bfloat16),
        v_new=torch.zeros(b, KV_HEADS, HEAD_DIM, dtype=torch.bfloat16),
        max_len=32)


def _heads(n, kv, h=HEAD_DIM):
    a = _good()
    b, n_pages, page = 3, 7, 16
    a.update(q=torch.zeros(b, n, h, dtype=torch.bfloat16),
             k_arena=torch.zeros(n_pages, page, kv, h, dtype=torch.bfloat16),
             v_arena=torch.zeros(n_pages, page, kv, h, dtype=torch.bfloat16),
             k_new=torch.zeros(b, kv, h, dtype=torch.bfloat16),
             v_new=torch.zeros(b, kv, h, dtype=torch.bfloat16))
    return a


def _cast(**kw):
    a = _good()
    a.update({k: a[k].to(v) for k, v in kw.items()})
    return a


_BAD = {
    "q_float16": (lambda: _cast(q=torch.float16), "share one dtype"),
    "arena_float32": (lambda: _cast(k_arena=torch.float32),
                      "share one dtype"),
    "all_float16": (lambda: _cast(q=torch.float16, k_arena=torch.float16,
                                  v_arena=torch.float16,
                                  k_new=torch.float16,
                                  v_new=torch.float16), "share one dtype"),
    "table_int64": (lambda: _cast(page_table=torch.int64), "int32"),
    "lengths_int64": (lambda: _cast(lengths=torch.int64), "int32"),
    "q_4d": (lambda: {**_good(), "q": torch.zeros(
        3, 1, N_HEADS, HEAD_DIM, dtype=torch.bfloat16)}, "are not"),
    "new_rows_shape": (lambda: {**_good(), "k_new": torch.zeros(
        3, 1, HEAD_DIM, dtype=torch.bfloat16)}, "do not fit"),
    "table_rows": (lambda: {**_good(), "page_table": torch.zeros(
        4, 2, dtype=torch.int32)}, "do not fit"),
    "v_arena_shape": (lambda: {**_good(), "v_arena": torch.zeros(
        7, 8, KV_HEADS, HEAD_DIM, dtype=torch.bfloat16)}, "do not fit"),
    "head_dim_24": (lambda: _heads(N_HEADS, KV_HEADS, 24), "head_dim 24"),
    "head_dim_32": (lambda: _heads(N_HEADS, KV_HEADS, 32), "head_dim 32"),
    "head_dim_256": (lambda: _heads(N_HEADS, KV_HEADS, 256),
                     "head_dim 256"),
    "ratio_not_whole": (lambda: _heads(6, 4), "ratio"),
    "ratio_17": (lambda: _heads(34, 2), "ratio"),
    "max_len_past_table": (lambda: {**_good(), "max_len": 33}, "max_len"),
    "max_len_0": (lambda: {**_good(), "max_len": 0}, "max_len"),
    "arena_not_contiguous": (lambda: {**_good(), "k_arena": torch.zeros(
        7, KV_HEADS, 16, HEAD_DIM, dtype=torch.bfloat16).transpose(1, 2)},
        "contiguous"),
    "q_not_contiguous": (lambda: {**_good(), "q": torch.zeros(
        3, HEAD_DIM, N_HEADS, dtype=torch.bfloat16).transpose(1, 2)},
        "contiguous"),
    "q_misaligned": (lambda: {**_good(), "q": torch.zeros(
        3 * N_HEADS * HEAD_DIM + 1, dtype=torch.bfloat16)[1:].view(
            3, N_HEADS, HEAD_DIM)}, "aligned"),
    "cpu_tensors": (_good, "CUDA tensor"),
}


@pytest.mark.parametrize("name", list(_BAD))
def test_wrapper_rejects_what_the_kernel_does_not_take(name):
    """The CUDA wrapper's checks run before it launches or builds
    anything; on CPU tensors that pass them it refuses the device."""
    make, match = _BAD[name]
    before = decode_attention_cuda.launches
    with pytest.raises(ValueError, match=match):
        decode_attention_cuda(**make())
    assert decode_attention_cuda.launches == before


def test_the_op_is_registered_with_its_cost_and_shape():
    op = registry.get_op("decode_attention")
    assert set(op.impls) == {"ref", "cuda"}
    a = _good()
    with pytest.raises(RuntimeError, match="no fallback"):
        decode_attention(**a, impl="cuda")
    flops, nbytes = registry.op_cost("decode_attention", *a.values())
    b, n, h = a["q"].shape
    assert flops == {"float32": 4.0 * b * n * h * a["max_len"]}
    assert nbytes >= 2 * b * a["max_len"] * KV_HEADS * h * 2
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in a.items()}
    out = decode_attention(**meta)
    assert out.is_meta and out.shape == (b, n, h) and out.dtype == a[
        "q"].dtype
