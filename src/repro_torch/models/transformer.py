"""Decoder-only LM covering the five LM architectures (counterpart of
``repro.models.transformer``): dense (qwen2-0.5b/7b, qwen3-4b) and MoE
(qwen2-moe-a2.7b: shared + routed top-4, ``moe_style="replace"``;
arctic-480b: a dense residual MLP in parallel with 128 experts top-2,
``moe_style="parallel"``; :mod:`repro_torch.models.moe`).

Parameters are a plain dict of tensors with the JAX package's names and
layout: ``embed``, ``final_norm``, ``lm_head`` (untied only) and
``layers``, whose leaves are stacked ``[n_layers, ...]``.  The layers run
as a Python loop where JAX scans; with ``remat`` (the default, as in
JAX) a training forward keeps only each layer's input and runs the layer
again in the backward pass (``torch.utils.checkpoint``).

Entry points:
  * ``lm_loss(params, batch, cfg)``     — training loss (blockwise attn);
    autograd gives its gradient.
  * ``prefill(params, tokens, cfg, max_len)`` — build a KV cache.
  * ``decode_step(params, token, cache, cfg)`` — one token; returns the
    final-norm hidden state so the serving engine can apply either the
    full vocab head or the LSS head (the paper's technique).
  * ``decode_step_pooled(params, token, k, v, lengths, cfg)`` — one token
    per POOL SLOT with per-row cache lengths (continuous batching; see
    ``repro_torch.serve.decode``).
  * ``decode_step_paged(...)`` — the same over a paged KV arena.
  * ``param_specs(cfg)`` / ``cache_specs(cfg, batch)`` — the layouts on a
    ``(data, model)`` mesh (:class:`~repro_torch.utils.sharding.P`).

The decode steps write the new KV into the cache tensors they are given,
IN PLACE, and return those same tensors: this takes the place of the
JAX package's functional cache update (and of its buffer donation on
TPU), and it is what lets the serving engine capture a step as a CUDA
graph over the pool's own slabs.

Sharded (``param_specs`` under a mesh the trainer makes active), the
vocab rows, the attention heads and the FFN columns are split over
``model`` as in the JAX package, and the same code runs on ``DTensor``
leaves.  Where JAX's GSPMD pads a head count that the model axis does
not divide, ``DTensor`` cannot split a head: q, k and v are then
replicated over ``model`` before their heads are unpacked (JAX does this
for decode only), and every model rank attends over all heads.
Attention itself runs on each rank's local heads and rows
(:func:`_attention`): its masks and chunk loop are plain tensors.  The
lookup, the gold logit and the log-sum-exp never gather the table or
the logits (:mod:`repro_torch.utils.sharding`).  The MoE layer runs on
the mesh too (experts over ``model``, ``moe_fsdp`` d_ff over ``data``;
:mod:`repro_torch.models.moe`).  A decode step over a ``DTensor`` cache
(``cache_specs``: the sequence split over ``model``, or over both axes
at a batch below 16) takes q, k and v whole over the cache's sequence
axes, writes the new position on the rank that holds it, and attends
over each rank's own positions: the max and the sum of the softmax and
the output are reduced over those axes (three all-reduces a layer).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.moe import MoEConfig, init_moe_params, moe_ffn
from repro_torch.utils.sharding import (P, contiguous_stride, embedding,
                                        is_dtensor, logsumexp, maybe_shard,
                                        mesh_axis_size, replicate,
                                        shard_range, vocab_iota)

__all__ = ["TransformerConfig", "init_params", "param_specs", "cache_specs",
           "forward", "logits_head", "gold_logit", "lm_loss", "KVCache",
           "init_cache", "prefill", "decode_step", "decode_step_pooled",
           "decode_step_paged"]


class TransformerConfig(NamedTuple):
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_base: float = 1e6
    tie_embeddings: bool = False
    # MoE: style "none" | "replace" (FFN -> MoE) | "parallel" (dense + MoE)
    moe_style: str = "none"
    n_experts: int = 0
    n_experts_padded: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    shared_expert_ff: int = 0
    capacity_factor: float = 1.25
    moe_fsdp: bool = False
    moe_groups: int = 1
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    kv_chunk: int = 512
    q_chunk: int = 2048    # long-prefill query chunking
    # the JAX package's "scan" | "unroll"; kept so that a JAX config's
    # fields carry over as they are: the port's layers always run as a
    # Python loop, which is JAX's "unroll"
    layers_impl: str = "scan"

    @property
    def moe_cfg(self) -> MoEConfig | None:
        if self.moe_style == "none":
            return None
        return MoEConfig(self.n_experts, self.moe_top_k, self.d_model,
                         self.moe_d_ff, self.n_experts_padded,
                         self.capacity_factor, n_groups=self.moe_groups)

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS cross-checks)."""
        d, f = self.d_model, self.d_ff
        nq = self.n_heads * self.head_dim
        nkv = self.n_kv_heads * self.head_dim
        attn = d * nq + 2 * d * nkv + nq * d
        if self.qkv_bias:
            attn += nq + 2 * nkv
        dense_ffn = 3 * d * f if self.moe_style in ("none", "parallel") else 0
        moe = 0
        if self.moe_style != "none":
            moe = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
        shared = (3 * d * self.shared_expert_ff + d
                  if self.shared_expert_ff else 0)
        if self.moe_style == "replace":
            dense_ffn = 0
        per_layer = attn + dense_ffn + moe + shared + 2 * d
        head = 0 if self.tie_embeddings else self.vocab * d
        return self.n_layers * per_layer + self.vocab * d + head + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if self.moe_style == "none":
            return self.param_count()
        inactive = (self.n_experts - self.moe_top_k) * 3 * self.d_model \
            * self.moe_d_ff * self.n_layers
        return self.param_count() - inactive


# ------------------------------------------------------------------ init --

def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device: str | torch.device | None = None) -> dict:
    """Normal draws scaled as the JAX package's ``init_params`` (embed
    N(0, 1); projections d_in**-0.5), unit norms, zero biases; drawn on
    ``generator``'s device in fp32, stored in ``cfg.dtype`` (norm scales
    and the MoE router in fp32) on ``device`` (the GPU unless the caller
    asks for the CPU).  The MoE leaves (``layers.moe``: router, w_gate,
    w_up, w_down, stacked ``[n_layers, ...]``) are drawn one layer's
    expert at a time (:func:`~repro_torch.models.moe.init_moe_params`)."""
    dev = resolve_device(device)
    dt = cfg.dtype
    n, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    nq = cfg.n_heads * cfg.head_dim
    nkv = cfg.n_kv_heads * cfg.head_dim
    s = d ** -0.5

    def nrm(shape, scale):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * scale).to(device=dev, dtype=dt)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    lyr = {"ln1": ones(n, d), "ln2": ones(n, d),
           "wq": nrm((n, d, nq), s), "wk": nrm((n, d, nkv), s),
           "wv": nrm((n, d, nkv), s), "wo": nrm((n, nq, d), nq ** -0.5)}
    if cfg.qkv_bias:
        lyr.update(bq=zeros(n, nq), bk=zeros(n, nkv), bv=zeros(n, nkv))
    if cfg.qk_norm:
        lyr.update(q_norm=ones(n, cfg.head_dim), k_norm=ones(n, cfg.head_dim))
    if cfg.moe_style in ("none", "parallel"):
        lyr.update(w_gate=nrm((n, d, f), s), w_up=nrm((n, d, f), s),
                   w_down=nrm((n, f, d), f ** -0.5))
    if cfg.moe_style != "none":
        lyr["moe"] = init_moe_params(generator, cfg.moe_cfg, dtype=dt,
                                     device=dev, n_layers=n)
    if cfg.shared_expert_ff:
        sf = cfg.shared_expert_ff
        lyr.update(sh_gate=nrm((n, d, sf), s), sh_up=nrm((n, d, sf), s),
                   sh_down=nrm((n, sf, d), sf ** -0.5),
                   sh_gate_w=nrm((n, d, 1), s))
    params = {"embed": nrm((cfg.vocab, d), 1.0), "layers": lyr,
              "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = nrm((cfg.vocab, d), s)
    return params


def param_specs(cfg: TransformerConfig) -> dict:
    """The layout of each parameter on a (data, model) mesh: vocab, d_ff,
    experts and the attention heads over ``model``; the expert tensors'
    d_ff also over ``data`` where ``moe_fsdp`` (JAX's keys and specs)."""
    lyr = {
        "ln1": P(None, None), "ln2": P(None, None),
        "wq": P(None, None, "model"),
        "wk": P(None, None, "model"),
        "wv": P(None, None, "model"),
        "wo": P(None, "model", None),
    }
    if cfg.qkv_bias:
        lyr["bq"] = P(None, "model")
        lyr["bk"] = P(None, "model")
        lyr["bv"] = P(None, "model")
    if cfg.qk_norm:
        lyr["q_norm"] = P(None, None)
        lyr["k_norm"] = P(None, None)
    if cfg.moe_style in ("none", "parallel"):
        lyr["w_gate"] = P(None, None, "model")
        lyr["w_up"] = P(None, None, "model")
        lyr["w_down"] = P(None, "model", None)
    if cfg.moe_style != "none":
        fs = "data" if cfg.moe_fsdp else None
        lyr["moe"] = {
            "router": P(None, None, None),
            "w_gate": P(None, "model", None, fs),
            "w_up": P(None, "model", None, fs),
            "w_down": P(None, "model", fs, None),
        }
    if cfg.shared_expert_ff:
        lyr["sh_gate"] = P(None, None, "model")
        lyr["sh_up"] = P(None, None, "model")
        lyr["sh_down"] = P(None, "model", None)
        lyr["sh_gate_w"] = P(None, None, None)
    specs = {
        "embed": P("model", None),
        "layers": lyr,
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P("model", None)
    return specs


def _layer_params(params: dict, i: int) -> dict:
    return {k: ({kk: v[i] for kk, v in a.items()} if isinstance(a, dict)
                else a[i]) for k, a in params["layers"].items()}


# -------------------------------------------------------------- forward ---

def _write_cache(cache: torch.Tensor, kv: torch.Tensor, pos: torch.Tensor
                 ) -> torch.Tensor:
    """Write the ``[B, 1, KV, H]`` step into ``cache[:, pos]`` IN PLACE
    (``pos`` [B], or a scalar all rows share) and return ``cache``.

    A row whose ``pos`` is past the end (``lengths == max_len``) writes
    nothing, as the JAX one-hot write falls off the slab: its slot keeps
    its bits (the row rewrites its own value), never clamped onto the
    last position."""
    b, s = cache.shape[:2]
    pos = torch.as_tensor(pos, device=cache.device).long().expand(b)
    rows = torch.arange(b, device=cache.device)
    at = pos.clamp(max=s - 1)
    new = torch.where((pos < s)[:, None, None], kv[:, 0].to(cache.dtype),
                      cache[rows, at])
    cache[rows, at] = new
    return cache


def _attention(q, k, v, cfg: TransformerConfig):
    """Blockwise causal attention over each rank's own rows and heads:
    ``DTensor`` q, k, v (laid out alike, heads whole on every rank) are
    taken apart into their local pieces and the output put back together
    the same way."""
    if not is_dtensor(q):
        return L.attention_blockwise(q, k, v, causal=True,
                                     kv_chunk=cfg.kv_chunk,
                                     q_chunk=cfg.q_chunk)
    out = L.attention_blockwise(q.to_local(), k.to_local(), v.to_local(),
                                causal=True, kv_chunk=cfg.kv_chunk,
                                q_chunk=cfg.q_chunk).contiguous()
    return type(q).from_local(out, q.device_mesh, q.placements,
                              run_check=False, shape=q.shape,
                              stride=contiguous_stride(q.shape))


def _attn_block(x, lp, cfg: TransformerConfig, rope, mode, cache=None,
                kv_len=None):
    """Shared attention block. mode: train | prefill | decode.  ``rope`` is
    ``rope_cos_sin`` at the block's positions."""
    b, s, _ = x.shape
    h = L.rms_norm(x, lp["ln1"])
    q = torch.einsum("bsd,dn->bsn", h, lp["wq"])
    k = torch.einsum("bsd,dn->bsn", h, lp["wk"])
    v = torch.einsum("bsd,dn->bsn", h, lp["wv"])
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    # a head count the model axis does not divide would split a head
    # when the packed [b, s, n*h] is unpacked: replicate q, k, v first
    # (JAX constrains decode alike; GSPMD pads the other modes)
    tp = mesh_axis_size("model")
    if tp and (cfg.n_heads % tp or cfg.n_kv_heads % tp):
        q = maybe_shard(q, P("data", None, None))
        k = maybe_shard(k, P("data", None, None))
        v = maybe_shard(v, P("data", None, None))
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, lp["q_norm"])
        k = L.rms_norm(k, lp["k_norm"])
    q = L.rotate(q, *rope)
    k = L.rotate(k, *rope)

    if mode == "decode" and is_dtensor(cache[0]):
        out = _decode_attention_sharded(q, k, v, cache[0], cache[1], kv_len)
        out = _rows_projection(out.reshape(b, s, cfg.n_heads * cfg.head_dim),
                               lp["wo"])
        return x + out, cache
    elif mode == "decode":
        pos = torch.as_tensor(kv_len, device=x.device) - 1   # write slot
        k_cache = _write_cache(cache[0], k, pos)
        v_cache = _write_cache(cache[1], v, pos)
        out = L.attention_decode(q, k_cache, v_cache, kv_len)
        new_cache = (k_cache, v_cache)
    else:
        out = _attention(q, k, v, cfg)
        new_cache = (k, v) if mode == "prefill" else None
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    if tp and (cfg.n_heads % tp or cfg.n_kv_heads % tp):
        # whole over model, its gradient too: the projection's gradient,
        # split over model by wo's rows, would otherwise reach the head
        # unpacking split where no head boundary falls
        out = maybe_shard(out, P("data", None, None))
    # heads split over model: each rank's share of the projection is a
    # partial sum, reduced by one all-reduce
    out = maybe_shard(torch.einsum("bsn,nd->bsd", out, lp["wo"]),
                      P("data", None, None))
    return x + out, new_cache


def _decode_attention_sharded(q, k, v, k_cache, v_cache, kv_len):
    """One decode step over a ``DTensor`` cache ``[B, S, KV, H]`` whose
    sequence is split over some mesh dims: q, k, v ([B, 1, ., H]) laid
    out as the cache's batch, the step's k and v written by the rank
    holding position ``kv_len - 1``, then a softmax over the split
    positions (its max, its sum and the output each all-reduced over the
    sequence's mesh dims).  Returns q's layout, the output whole over the
    sequence dims."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, cp = k_cache.device_mesh, tuple(k_cache.placements)
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in cp)
    q, k, v = (t.redistribute(mesh, rows) if tuple(t.placements) != rows
               else t for t in (q, k, v))
    seq_dims = [i for i, p in enumerate(cp) if p.is_shard(1)]
    kc, vc = k_cache.to_local(), v_cache.to_local()
    lo, hi = shard_range(k_cache.shape[1], mesh, cp, 1)
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    b, _, n, h = ql.shape
    kv_len = torch.as_tensor(kv_len, device=kc.device)
    pos = (kv_len - 1).expand(b) if kv_len.dim() == 0 else kv_len - 1
    mine = (pos >= lo) & (pos < hi)
    at = torch.where(mine, pos - lo, hi - lo)          # past the end: none
    _write_cache(kc, kl, at)
    _write_cache(vc, vl, at)

    def reduce(t, op):
        for i in seq_dims:
            t = funcol.wait_tensor(funcol.all_reduce(t, op,
                                                     mesh.get_group(i)))
        return t

    kv = kc.shape[2]
    r = n // kv
    spos = lo + torch.arange(hi - lo, device=kc.device)
    valid = spos[None, :] < kv_len.reshape(-1, 1)             # [B or 1, S]
    qg = (ql.float() * h ** -0.5).reshape(b, 1, kv, r, h)
    logits = torch.einsum("bqgrh,bkgh->bgrqk", qg, kc.float())
    logits = torch.where(valid[:, None, None, None, :], logits, L.NEG_INF)
    m = reduce(logits.amax(-1, keepdim=True), "max")
    p = torch.exp(logits - m)
    denom = reduce(p.sum(-1, keepdim=True), "sum")
    out = reduce(torch.einsum("bgrqk,bkgh->bqgrh", p, vc.float()), "sum")
    out = (out / denom.permute(0, 3, 1, 2, 4)).reshape(b, 1, n, h)
    return DTensor.from_local(out.to(ql.dtype), mesh, rows, run_check=False,
                              shape=q.shape, stride=q.stride())


def _rows_projection(out, wo):
    """``out @ wo`` for a sharded decode step: ``out`` [B, 1, n*h] whole
    over ``model``, ``wo`` [n*h, d] split by rows over it.  Each rank
    multiplies its rows' slice of ``out`` by its rows of ``wo`` and the
    partial sums are reduced over ``model`` (one all-reduce), the result
    laid out as ``out``'s batch."""
    from torch.distributed.tensor import DTensor, Partial

    mesh, wp = wo.device_mesh, tuple(wo.placements)
    lo, hi = shard_range(wo.shape[0], mesh, wp, 0)
    y = out.to_local()[..., lo:hi] @ wo.to_local()
    pl = [Partial() if w.is_shard(0) else o
          for w, o in zip(wp, out.placements)]
    shape = tuple(out.shape[:-1]) + (wo.shape[1],)
    y = DTensor.from_local(y, mesh, pl, run_check=False, shape=shape,
                           stride=contiguous_stride(shape))
    batch = any(p.is_shard(0) for p in out.placements)
    return maybe_shard(y, P("data" if batch else None, None, None))


def _rows_spec(x) -> P:
    """``[B, ...]`` activations split over ``data`` by rows where the
    data axis divides B (a decode step of one row is whole)."""
    dp = mesh_axis_size("data")
    return P("data" if dp and x.shape[0] % dp == 0 else None,
             *([None] * (x.dim() - 1)))


def _ffn_block(x, lp, cfg: TransformerConfig):
    """The dense SwiGLU, the MoE, or both in parallel, plus the shared
    expert with its sigmoid gate -> (x + out, the MoE's aux loss; None
    for a dense layer)."""
    b, s, d = x.shape
    rows = _rows_spec(x)
    h = maybe_shard(L.rms_norm(x, lp["ln2"]), rows)
    dense = None
    if cfg.moe_style in ("none", "parallel"):
        dense = maybe_shard(L.swiglu(h, lp["w_gate"], lp["w_up"],
                                     lp["w_down"]), rows)
    if cfg.moe_style == "none":
        return x + dense, None
    moe_out, aux = moe_ffn(h.reshape(b * s, d), lp["moe"], cfg.moe_cfg)
    out = moe_out.reshape(b, s, d)
    if dense is not None:
        out = dense + out
    if cfg.shared_expert_ff:
        gate = torch.sigmoid(torch.einsum("bsd,dz->bsz", h,
                                          lp["sh_gate_w"]).float())
        sh = maybe_shard(L.swiglu(h, lp["sh_gate"], lp["sh_up"],
                                  lp["sh_down"]), rows)
        out = out + sh * gate.to(sh.dtype)
    return x + out, aux


def _layer(x, lp, cfg, rope, mode, cache=None, kv_len=None):
    x, new_cache = _attn_block(x, lp, cfg, rope, mode, cache, kv_len)
    x, aux = _ffn_block(x, lp, cfg)
    return x, new_cache, aux


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            mode: str = "train"):
    """tokens [B, S] -> (hidden [B, S, D] after final norm, caches, aux).

    ``caches`` (prefill only) is ``(k, v)``, each ``[L, B, S, KV, H]``;
    ``aux`` is the MoE balance loss summed over the layers, 0 for the
    dense architectures."""
    x = maybe_shard(embedding(params["embed"], tokens),
                    P("data", None, None)).to(cfg.dtype)
    # every row's positions are 0..S-1: one row of cos/sin broadcasts
    positions = torch.arange(tokens.shape[1],
                             device=_local(tokens).device)[None]
    rope = tuple(_replicated_like(t, x) for t in L.rope_cos_sin(
        positions, cfg.head_dim, cfg.rope_base))
    ks, vs = [], []
    aux = torch.zeros((), dtype=torch.float32, device=_local(x).device)
    # a training step keeps each layer's input only and runs the layer
    # again in the backward pass (JAX's jax.checkpoint of a layer)
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        if remat:
            x, cache, aux_i = torch.utils.checkpoint.checkpoint(
                _layer, x, lp, cfg, rope, mode, use_reentrant=False)
        else:
            x, cache, aux_i = _layer(x, lp, cfg, rope, mode)
        if aux_i is not None:
            aux = aux + aux_i
        if mode == "prefill":
            ks.append(cache[0])
            vs.append(cache[1])
    caches = (torch.stack(ks), torch.stack(vs)) if mode == "prefill" else None
    if cfg.moe_style == "none":
        aux = _replicated_like(aux, x)
    return L.rms_norm(x, params["final_norm"]), caches, aux


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def _replicated_like(t: torch.Tensor, ref):
    """``t`` (the same on every rank) as a replicated ``DTensor`` on
    ``ref``'s mesh where ``ref`` is one, else as it is."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import Replicate
    mesh = ref.device_mesh
    return type(ref).from_local(t, mesh, [Replicate()] * mesh.ndim,
                                run_check=False)


def logits_head(params: dict, hidden: torch.Tensor,
                cfg: TransformerConfig) -> torch.Tensor:
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,vd->bsv", hidden, head).float()


def gold_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The label's logit, extracted so that it stays sharded.

    A gather over a vocab-sharded axis all-gathers the whole ``[B, S, V]``
    logits (JAX measured 33 GB a device on qwen2-0.5b).  The iota-mask
    sum partitions cleanly: each shard contributes its local slice,
    combined by one ``[B, S]`` all-reduce."""
    iota = vocab_iota(logits)
    return replicate(torch.where(iota == labels[..., None], logits,
                                 0.0).sum(-1))


def lm_loss(params: dict, batch: dict, cfg: TransformerConfig
            ) -> torch.Tensor:
    """batch: tokens [B, S] int, labels [B, S] (-100 = masked)."""
    hidden, _, aux = forward(params, batch["tokens"], cfg, mode="train")
    logits = logits_head(params, hidden, cfg)
    labels = batch["labels"]
    mask = labels >= 0
    logz = logsumexp(logits, -1)
    gold = gold_logit(logits, labels.clamp(min=0))
    nll = (logz - gold) * mask
    loss = nll.sum() / mask.sum().clamp(min=1)
    return loss + 0.01 * aux


# ---------------------------------------------------------------- serving --

class KVCache(NamedTuple):
    k: torch.Tensor    # [n_layers, B, S_max, KV, H]
    v: torch.Tensor
    length: int | torch.Tensor   # valid prefix length (an int or int [])


def cache_specs(cfg: TransformerConfig, batch: int) -> KVCache:
    """Sharding policy: batch over data when it divides, else the sequence
    axis takes both mesh axes (long-context batch=1 decode)."""
    if batch >= 16:
        spec = P(None, "data", "model", None, None)
    else:
        spec = P(None, None, ("data", "model"), None, None)
    return KVCache(spec, spec, P())


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype: torch.dtype | None = None,
               device: str | torch.device | None = None) -> KVCache:
    dt = dtype or cfg.dtype
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return KVCache(torch.zeros(shape, dtype=dt, device=dev),
                   torch.zeros(shape, dtype=dt, device=dev), 0)


def prefill(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            max_len: int) -> tuple[torch.Tensor, KVCache]:
    """Run the prompt; returns (final-norm hidden [B, S, D], cache)."""
    hidden, (k, v), _ = forward(params, tokens, cfg, mode="prefill")
    pad = max_len - tokens.shape[1]         # [L, B, S, KV, H]
    if pad > 0:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return hidden, KVCache(k.to(cfg.dtype), v.to(cfg.dtype),
                           int(tokens.shape[1]))


def _decode_layers(params: dict, token: torch.Tensor,
                   layer_cache: Callable, positions: torch.Tensor, kv_len,
                   cfg: TransformerConfig,
                   after: Callable | None = None) -> torch.Tensor:
    """Shared one-token layer loop.  token [B]; ``layer_cache(i)`` gives
    layer i's ``(k, v)`` ``[B, S, KV, H]``, which the layer writes in
    place; ``after(i, k, v)`` runs once layer i has attended; positions
    [B, 1], kv_len scalar or [B] -> hidden [B, D].  Every op is
    row-parallel over B, but for the MoE's capacity: a row's tokens drop
    only when more than C = max(8, ...) rows pick one expert, so at B <= 8
    nothing drops."""
    x = embedding(params["embed"], token[:, None]).to(cfg.dtype)  # [B, 1, D]
    rope = L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_base)
    k0 = layer_cache(0)[0]
    if is_dtensor(x) and is_dtensor(k0):
        # the batch laid out as the cache's (over data, or whole)
        x = maybe_shard(x, P("data" if any(p.is_shard(0) for p in
                                          k0.placements) else None,
                             None, None))
        rope = tuple(_replicated_like(t, x) for t in rope)
    for i in range(cfg.n_layers):
        x, (k_i, v_i), _ = _layer(x, _layer_params(params, i), cfg, rope,
                                  "decode", layer_cache(i), kv_len)
        if after is not None:
            after(i, k_i, v_i)
    return L.rms_norm(x[:, 0], params["final_norm"])


def decode_step(params: dict, token: torch.Tensor, cache: KVCache,
                cfg: TransformerConfig) -> tuple[torch.Tensor, KVCache]:
    """One decode step. token [B] int -> (hidden [B, D], new cache).

    Writes the step's KV into ``cache.k``/``cache.v`` in place; the new
    cache holds the same tensors and ``length + 1``.  The caller applies
    the head: ``logits_head`` for exact serving or the LSS index
    (``repro_torch.core``) for sub-linear WOL serving.
    """
    b = token.shape[0]
    kv_len = cache.length + 1
    if isinstance(cache.length, torch.Tensor):
        positions = cache.length.long().reshape(1, 1).expand(b, 1)
    else:
        positions = torch.full((b, 1), cache.length, dtype=torch.long,
                               device=_local(token).device)
    hidden = _decode_layers(params, token, lambda i: (cache.k[i], cache.v[i]),
                            positions, kv_len, cfg)
    return hidden, KVCache(cache.k, cache.v, kv_len)


def decode_step_pooled(params: dict, token: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, lengths: torch.Tensor,
                       cfg: TransformerConfig
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step over a slot pool with PER-ROW cache lengths.

    token [B] int, k/v [L, B, S_max, KV, H] slabs, lengths [B] int
    (current valid prefix per slot) -> (hidden [B, D], k, v), the slabs
    written in place at each row's own position.

    Row ``i`` computes exactly what :func:`decode_step` computes for a
    batch-1 cache of the same width ``S_max`` — every op is row-parallel.
    """
    hidden = _decode_layers(params, token, lambda i: (k[i], v[i]),
                            lengths[:, None].long(), lengths + 1, cfg)
    return hidden, k, v


def decode_step_paged(params: dict, token: torch.Tensor,
                      k_arena: torch.Tensor, v_arena: torch.Tensor,
                      page_table: torch.Tensor, lengths: torch.Tensor,
                      cfg: TransformerConfig, max_len: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`decode_step_pooled` over PAGED KV storage.

    token [B] int, k/v arenas [L, n_pages, page_tokens, KV, H],
    page_table [B, pages_per_slot] int (0 = unmapped -> the reserved
    scratch page), lengths [B] int -> (hidden [B, D], k_arena, v_arena).

    Bit-identity with the dense layout is by construction: each layer
    gathers every row's pages IN ORDER into a contiguous view sliced to
    exactly ``max_len`` — the shape the dense slab presents — so the
    layer runs the very same reduction over the very same valid contents
    (positions >= lengths are masked to exact zeros either way).  Slicing
    to ``max_len`` (not ``pages_per_slot * page_tokens``) is
    load-bearing: reductions are not shape-invariant at the ulp level, on
    the CPU or in cuBLAS.

    The gather materialises one layer's ``[B, max_len, KV, H]`` view at a
    time, so the paged layout's savings are in PERSISTENT arena bytes.
    The new KV row is scattered back into each row's current write page
    (page ``lengths // p``, offset ``lengths % p``).  Rows that must not
    write — parked slots and rows at ``lengths == max_len`` — are sent to
    scratch page 0, so a freed slot's in-flight step can never corrupt a
    recycled page.
    """
    _, _, p, n_kv, h_dim = k_arena.shape
    b, n_pp = page_table.shape
    w = max_len
    table = page_table.long()
    lengths = lengths.long()
    rows = torch.arange(b, device=lengths.device)
    wpos = lengths.clamp(0, w - 1)
    pidx = (lengths // p).clamp(0, n_pp - 1)
    dest = torch.where(lengths < w, table[rows, pidx], 0)   # full -> scratch
    off = torch.where(lengths < w, lengths % p, 0)

    def view(arena, i):
        return arena[i][table].reshape(b, n_pp * p, n_kv, h_dim)[
            :, :w].contiguous()

    def scatter(i, k_view, v_view):
        k_arena[i][dest, off] = k_view[rows, wpos]
        v_arena[i][dest, off] = v_view[rows, wpos]

    hidden = _decode_layers(
        params, token, lambda i: (view(k_arena, i), view(v_arena, i)),
        lengths[:, None], lengths + 1, cfg, after=scatter)
    return hidden, k_arena, v_arena
