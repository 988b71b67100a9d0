"""The port's transformer layers (``repro_torch.models.layers``) against
the JAX package's (``repro.models.layers``) on the same numpy inputs,
within 1e-5: norms, RoPE, naive / blockwise / decode attention (the
grouped GQA form and the ``r == 1`` branch), SwiGLU; plus the
reference's own properties (counterpart of the dense parts of
``tests/test_layers.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.testing.parity import assert_close  # noqa: E402

TOL = 1e-5          # fp32; the two packages sum in other orders


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _qkv(b, s, n, kv, h, seed=0):
    return _normal(seed, b, s, n, h), _normal(seed + 1, b, s, kv, h), \
        _normal(seed + 2, b, s, kv, h)


@pytest.mark.parametrize("kv,qc,kc", [(4, None, 16), (2, 16, 16),
                                      (1, 32, 24), (4, 64, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_matches_jax_and_naive(kv, qc, kc, causal):
    q, k, v = _qkv(2, 64, 4, kv, 16)
    want = JL.attention_blockwise(q, k, v, causal=causal, kv_chunk=kc,
                                  q_chunk=qc)
    got = L.attention_blockwise(_t(q), _t(k), _t(v), causal=causal,
                                kv_chunk=kc, q_chunk=qc)
    assert_close(got, want, rtol=TOL, atol=TOL, what="blockwise")
    naive = L.attention_naive(_t(q), _t(k), _t(v), causal=causal)
    assert_close(naive, JL.attention_naive(q, k, v, causal=causal),
                 rtol=TOL, atol=TOL, what="naive")
    assert_close(got, naive, rtol=2e-5, atol=2e-5, what="blockwise-naive")


@pytest.mark.parametrize("n,kv", [(4, 2), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_matches_jax(n, kv, per_row):
    """The grouped einsum (GQA) and the r == 1 branch, with one shared
    length and with a length per row (continuous batching)."""
    q = _normal(3, 3, 1, n, 16)
    kc, vc = _normal(4, 3, 48, kv, 16), _normal(5, 3, 48, kv, 16)
    kv_len = np.array([5, 33, 48], np.int32) if per_row else 33
    want = JL.attention_decode(q, kc, vc, kv_len)
    got = L.attention_decode(_t(q), _t(kc), _t(vc),
                             _t(kv_len) if per_row else kv_len)
    assert_close(got, want, rtol=TOL, atol=TOL, what="attention_decode")


def test_decode_matches_naive_last_position():
    b, s, n, kv, h = 2, 33, 4, 2, 16
    q, k, v = _qkv(b, s, n, kv, h, seed=3)
    ref = L.attention_naive(_t(q), _t(k), _t(v), causal=True)
    pad = ((0, 0), (0, 48 - s), (0, 0), (0, 0))
    out = L.attention_decode(_t(q[:, -1:]), _t(np.pad(k, pad)),
                             _t(np.pad(v, pad)), kv_len=s)
    assert_close(out, ref[:, -1:], rtol=2e-5, atol=2e-5, what="decode")


def test_rope_matches_jax_and_keeps_norm():
    x = _normal(0, 2, 8, 2, 32)
    pos = np.tile(np.arange(8, dtype=np.int32), (2, 1)) * 37
    got = L.apply_rope(_t(x), _t(pos), 1e6)
    assert_close(got, JL.apply_rope(x, pos, 1e6), rtol=TOL, atol=TOL,
                 what="rope")
    assert_close(got.norm(dim=-1), np.linalg.norm(x, axis=-1), rtol=1e-5,
                 atol=1e-5, what="rope norm")
    assert_close(L.rope_freqs(32, 1e4), JL.rope_freqs(32, 1e4), rtol=TOL,
                 atol=0, what="rope_freqs")


def test_rope_relative_position():
    q, k = _t(_normal(1, 1, 1, 1, 32)), _t(_normal(2, 1, 1, 1, 32))

    def ip(pq, pk):
        rq = L.apply_rope(q, torch.tensor([[pq]]))
        rk = L.apply_rope(k, torch.tensor([[pk]]))
        return float((rq * rk).sum())

    assert abs(ip(0, 5) - ip(7, 12)) < 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(dtype):
    x = _normal(0, 4, 6, 32)
    scale, bias = _normal(1, 32), _normal(2, 32)
    jx = jnp.asarray(x, dtype)
    tx = _t(x).to(getattr(torch, dtype))
    for got, want in (
            (L.rms_norm(tx, _t(scale)), JL.rms_norm(jx, scale)),
            (L.layer_norm(tx, _t(scale), _t(bias)),
             JL.layer_norm(jx, scale, bias))):
        assert got.dtype == tx.dtype
        tol = TOL if dtype == "float32" else 1e-2     # one bf16 ulp
        assert_close(got.float(), np.asarray(want, np.float32), rtol=tol,
                     atol=tol, what=f"norm {dtype}")


def test_rms_norm_unit_scale():
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    y = L.rms_norm(x, torch.ones(4))
    assert_close(y, x / x.square().mean().sqrt(), rtol=1e-5, atol=0,
                 what="rms_norm")


def test_swiglu_matches_jax():
    x = _normal(0, 2, 3, 16)
    wg, wu, wd = _normal(1, 16, 24), _normal(2, 16, 24), _normal(3, 24, 16)
    want = jax.jit(JL.swiglu)(x, wg, wu, wd)
    got = L.swiglu(_t(x), _t(wg), _t(wu), _t(wd))
    assert_close(got, want, rtol=TOL, atol=TOL, what="swiglu")


def test_repeat_kv():
    k = _t(_normal(0, 2, 5, 2, 4))
    r = L._repeat_kv(k, 3)
    assert r.shape == (2, 5, 6, 4)
    assert torch.equal(r[:, :, 4], k[:, :, 1])
    assert L._repeat_kv(k, 1) is k
