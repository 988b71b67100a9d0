"""Shared transformer layers: norms, RoPE, GQA attention, SwiGLU
(counterpart of ``repro.models.layers``).

Attention has three execution paths, as in the JAX package:

  * ``naive``     — full [S, S] scores; oracle for tests.
  * ``blockwise`` — online softmax over KV chunks (a Python loop where JAX
                    scans); memory O(S·c) instead of O(S²); the training
                    and prefill path.
  * ``decode``    — one query position against a KV cache.

Every path keeps the JAX formulas: fp32 upcast of the operands, a
``NEG_INF`` mask, then softmax.  ``scaled_dot_product_attention`` is not
used: the dense and paged decode steps are bit-identical only because
both run this same reduction over the same shape.  Functions are pure
on tensors, except that nothing here writes its inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["NEG_INF", "rms_norm", "layer_norm", "rope_freqs", "rope_cos_sin",
           "rotate", "apply_rope", "attention_naive", "attention_blockwise",
           "attention_decode", "swiglu"]

NEG_INF = -1e30


# ------------------------------------------------------------------ norms --

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


# ------------------------------------------------------------------- rope --

def rope_freqs(head_dim: int, base: float = 1e6,
               device: torch.device | str | None = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(base, exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, base: float = 1e6
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``cos``/``sin`` ``[B, S, 1, H/2]`` of the rotation at ``positions``
    ``[B, S]`` (made once a forward, shared by q and k of every layer)."""
    freqs = rope_freqs(head_dim, base, positions.device)        # [H/2]
    angles = positions[..., None].float() * freqs               # [B, S, H/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """RoPE of ``x [B, S, N, H]`` with :func:`rope_cos_sin`'s tables."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 1e6) -> torch.Tensor:
    """x: ``[B, S, N, H]``, positions: ``[B, S]`` (int)."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], base))


# -------------------------------------------------------------- attention --

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """``[B, S, KV, H] -> [B, S, KV*n_rep, H]`` for GQA."""
    if n_rep == 1:
        return k
    b, s, kv, h = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, h).reshape(
        b, s, kv * n_rep, h)


def attention_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Oracle. q: [B,S,N,H]; k,v: [B,S,KV,H]."""
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) * scale
    if causal:
        s = q.shape[1]
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqk,bknh->bqnh", probs, v.float())
    return out.to(q.dtype)


def attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, kv_chunk: int = 512,
                        q_chunk: int | None = None) -> torch.Tensor:
    """Online-softmax attention, O(S·chunk) memory. Shapes as naive.

    ``q_chunk``: additionally loop over query chunks (long prefill, where
    even one [B, N, S, kv_chunk] score tile would be too large).
    """
    if q_chunk is not None and q.shape[1] > q_chunk:
        s = q.shape[1]
        if s % q_chunk:
            raise ValueError(f"sequence {s} is not a multiple of q_chunk "
                             f"{q_chunk}")
        return torch.cat([
            _attention_blockwise_inner(q[:, i:i + q_chunk], k, v, causal,
                                       kv_chunk, q_offset=i)
            for i in range(0, s, q_chunk)], dim=1)
    return _attention_blockwise_inner(q, k, v, causal, kv_chunk, q_offset=0)


def _attention_blockwise_inner(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, causal: bool, kv_chunk: int,
                               q_offset: int) -> torch.Tensor:
    b, s, n, h = q.shape
    kv_heads = k.shape[2]
    n_rep = n // kv_heads
    scale = h ** -0.5
    kv_len = k.shape[1]
    kv_chunk = min(kv_chunk, kv_len)
    pad = (-kv_len) % kv_chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    n_chunks = k.shape[1] // kv_chunk
    q32 = q.float() * scale
    qpos = q_offset + torch.arange(s, device=q.device)

    m = torch.full((b, n, s), NEG_INF, dtype=torch.float32, device=q.device)
    l_sum = torch.zeros((b, n, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n, s, h), dtype=torch.float32, device=q.device)
    for j in range(n_chunks):
        sl = slice(j * kv_chunk, (j + 1) * kv_chunk)
        kj = _repeat_kv(k[:, sl], n_rep).float()            # [B, c, N, H]
        vj = _repeat_kv(v[:, sl], n_rep).float()
        logits = torch.einsum("bqnh,bknh->bnqk", q32, kj)   # [B,N,S,c]
        kpos = j * kv_chunk + torch.arange(kv_chunk, device=q.device)
        mask = (kpos[None, :] < kv_len).expand(s, kv_chunk)
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        logits = torch.where(mask[None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))           # [B,N,S]
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l_sum = l_sum * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bnqk,bknh->bnqh", p, vj)
        m = m_new
    out = acc / l_sum.clamp(min=1e-30)[..., None]           # [B,N,S,H]
    return out.movedim(1, 2).to(q.dtype)                    # [B,S,N,H]


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len) -> torch.Tensor:
    """One-step decode. q: [B,1,N,H]; caches: [B,S,KV,H]; kv_len: valid
    length, an int or 0-d tensor (all rows share one length) or a [B]
    tensor (continuous batching: each row of the pool has its own valid
    prefix).

    GQA through the GROUPED einsum of the JAX package (the head repeat is
    never materialised); MHA (``r == 1``) through the plain 4-D einsum.
    """
    b, one, n, h = q.shape
    kv = k_cache.shape[2]
    r = n // kv
    scale = h ** -0.5
    k32 = k_cache.float()
    v32 = v_cache.float()
    spos = torch.arange(k_cache.shape[1], device=q.device)
    kv_len = torch.as_tensor(kv_len, device=q.device)
    valid = spos[None, :] < kv_len.reshape(-1, 1)            # [B or 1, S]
    if r == 1:
        q32 = q.float() * scale
        logits = torch.einsum("bqnh,bknh->bnqk", q32, k32)
        logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bnqk,bknh->bqnh", probs, v32)
        return out.to(q.dtype)
    qg = (q.float() * scale).reshape(b, one, kv, r, h)
    logits = torch.einsum("bqgrh,bkgh->bgrqk", qg, k32)     # [B,KV,r,1,S]
    logits = torch.where(valid[:, None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgh->bqgrh", probs, v32)
    return out.reshape(b, one, n, h).to(q.dtype)


# ------------------------------------------------------------------ ffn ----

def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("...d,df->...f", x, w_gate)
    u = torch.einsum("...d,df->...f", x, w_up)
    return torch.einsum("...f,fd->...d", F.silu(g) * u, w_down)
