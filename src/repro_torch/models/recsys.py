"""RecSys architectures: DeepFM, AutoInt, DIEN, BERT4Rec (counterpart of
``repro.models.recsys``).

The shared substrate is the sparse embedding path: a row gather plus
masked reductions (:func:`embedding_bag` for ragged bags, ids padded
-1).  CTR models use one unified table ``[sum(vocab_f), dim]`` with
per-field offsets, row-sharded over ``model`` in their specs.

BERT4Rec's next-item softmax over a 1M-item catalogue is a WOL: the
paper's technique (LSS, :mod:`repro_torch.core`) serves it sub-linearly
from the last position's hidden (:func:`retrieval_scores` is the exact
full-catalogue baseline).

On a mesh (``DTensor`` leaves laid out by the ``*_specs``, the batch
over ``data``), the same code runs: the row-sharded tables (the CTR
models' unified table, BERT4Rec's items and head) are read through the
vocab-parallel lookup of :func:`repro_torch.utils.sharding.embedding`
(each rank looks up the ids among its rows; the rows are summed over
``model`` by one all-reduce of the looked-up activations, and a table's
gradient stays on its rows), and the dense layers run on ``DTensor``
activations.  AutoInt's q, k and v are gathered whole over ``model``
before their heads are unpacked.

Parameters are plain dicts (lists where the JAX package has lists) with
the JAX package's names and layout; GRUs run as a Python loop where JAX
scans.  Draws are N(0, 1) scaled as the JAX package's, on ``generator``'s
device, stored on ``device`` (the GPU unless the caller asks for the
CPU); the two frameworks draw different numbers, so the parity tests
carry JAX's weights over.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.utils.sharding import (P, embedding, is_dtensor, map_local,
                                        maybe_shard, mesh_axis_size,
                                        replicate)

__all__ = ["embedding_lookup", "embedding_bag", "CTRConfig", "field_offsets",
           "init_deepfm", "deepfm_specs", "deepfm_logits", "init_autoint",
           "autoint_specs", "autoint_logits", "init_dien", "dien_specs",
           "dien_logits", "Bert4RecConfig", "init_bert4rec",
           "bert4rec_specs", "bert4rec_encode", "bert4rec_loss",
           "retrieval_scores"]


# ------------------------------------------------------- embedding bags ----

def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain row gather ``[V, D] x [...] -> [..., D]`` (one id per field);
    over a ``DTensor`` table, the vocab-parallel lookup, laid out as
    ``ids``."""
    if is_dtensor(table):
        return replicate(embedding(table, ids))
    return table[ids.long()]


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mode: str = "mean",
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """EmbeddingBag over ragged bags. ids: ``[B, F]`` padded -1."""
    mask = ids >= 0
    rows = embedding_lookup(table, ids.clamp(min=0))      # [B, F, D]
    if weights is not None:
        rows = rows * weights[..., None].to(rows.dtype)
    rows = torch.where(mask[..., None], rows, 0)
    if mode == "sum":
        return rows.sum(1)
    if mode == "mean":
        return rows.sum(1) / mask.sum(1).clamp(min=1)[:, None].to(rows.dtype)
    if mode == "max":
        return torch.where(mask[..., None], rows, float("-inf")).amax(1)
    raise ValueError(mode)


def _mlp(x: torch.Tensor, ws: Sequence[torch.Tensor],
         bs: Sequence[torch.Tensor], final_act: bool = False) -> torch.Tensor:
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = x @ w + b
        if i < len(ws) - 1 or final_act:
            x = torch.relu(x)
    return x


def _normal(generator: torch.Generator, shape, scale: float,
            dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * scale).to(device=dev, dtype=dtype)


def _init_mlp(generator, dims, dtype, dev):
    ws = [_normal(generator, (dims[i], dims[i + 1]), dims[i] ** -0.5, dtype,
                  dev) for i in range(len(dims) - 1)]
    bs = [torch.zeros((dims[i + 1],), dtype=dtype, device=dev)
          for i in range(len(dims) - 1)]
    return ws, bs


# ---------------------------------------------------------------- DeepFM ---

class CTRConfig(NamedTuple):
    name: str
    kind: str                      # deepfm | autoint | dien
    n_fields: int = 39
    vocab_per_field: int = 100_000   # synthetic uniform field vocab
    embed_dim: int = 10
    mlp_dims: tuple = (400, 400, 400)
    # autoint
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    # dien
    seq_len: int = 100
    gru_dim: int = 108
    # the JAX package's dry-run switch (scan or unroll); kept so that a
    # JAX config's fields carry over as they are: the port's GRUs always
    # run as a Python loop
    unroll_scan: bool = False
    dtype: torch.dtype = torch.float32

    @property
    def total_vocab(self) -> int:
        return self.n_fields * self.vocab_per_field

    def param_count(self) -> int:
        n = self.total_vocab * self.embed_dim
        if self.kind == "deepfm":
            n += self.total_vocab  # linear term
            dims = [self.n_fields * self.embed_dim, *self.mlp_dims, 1]
            n += sum(dims[i] * dims[i + 1] + dims[i + 1]
                     for i in range(len(dims) - 1))
        return n


def field_offsets(cfg: CTRConfig, device: str | torch.device | None = None
                  ) -> torch.Tensor:
    """Each field's first row in the unified table (int64 ``[n_fields]``)."""
    return torch.arange(cfg.n_fields, device=device) * cfg.vocab_per_field


def _global_ids(ids: torch.Tensor, cfg: CTRConfig) -> torch.Tensor:
    return map_local(
        lambda t: t.long() + field_offsets(cfg, t.device)[None, :], ids)


def init_deepfm(generator: torch.Generator, cfg: CTRConfig,
                device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    dims = [cfg.n_fields * cfg.embed_dim, *cfg.mlp_dims, 1]
    table = _normal(generator, (cfg.total_vocab, cfg.embed_dim), 0.01,
                    cfg.dtype, dev)
    linear = _normal(generator, (cfg.total_vocab,), 0.01, cfg.dtype, dev)
    ws, bs = _init_mlp(generator, dims, cfg.dtype, dev)
    return {"table": table, "linear": linear, "mlp_w": ws, "mlp_b": bs,
            "bias": torch.zeros((), dtype=cfg.dtype, device=dev)}


def deepfm_specs(cfg: CTRConfig) -> dict:
    return {
        "table": P("model", None), "linear": P("model"),
        "mlp_w": [P(None, None)] * (len(cfg.mlp_dims) + 1),
        "mlp_b": [P(None)] * (len(cfg.mlp_dims) + 1),
        "bias": P(),
    }


def deepfm_logits(params: dict, ids: torch.Tensor, cfg: CTRConfig
                  ) -> torch.Tensor:
    """ids: int ``[B, n_fields]`` (field-local); returns CTR logit [B]."""
    gids = _global_ids(ids, cfg)
    emb = embedding_lookup(params["table"], gids)          # [B, F, D]
    lin = (embedding_lookup(params["linear"][:, None], gids)[..., 0]
           if is_dtensor(params["linear"])
           else params["linear"][gids]).sum(-1)            # [B]
    # FM second-order: 0.5 * ((sum v)^2 - sum v^2)
    s = emb.sum(1)
    fm = 0.5 * (s.square() - emb.square().sum(1)).sum(-1)
    deep = _mlp(emb.reshape(ids.shape[0], -1), params["mlp_w"],
                params["mlp_b"])[:, 0]
    return (lin + fm + deep + params["bias"]).float()


# --------------------------------------------------------------- AutoInt ---

def init_autoint(generator: torch.Generator, cfg: CTRConfig,
                 device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    d, da, nh = cfg.embed_dim, cfg.d_attn, cfg.n_heads
    table = _normal(generator, (cfg.total_vocab, d), 0.01, cfg.dtype, dev)
    d_out = cfg.n_fields * da * nh
    w_out = _normal(generator, (d_out, 1), d_out ** -0.5, cfg.dtype, dev)
    layers = []
    for i in range(cfg.n_attn_layers):
        d_in = d if i == 0 else da * nh
        layers.append({n: _normal(generator, (d_in, nh * da), d_in ** -0.5,
                                  cfg.dtype, dev)
                       for n in ("wq", "wk", "wv", "wres")})
    return {"table": table, "attn": layers, "w_out": w_out,
            "bias": torch.zeros((), dtype=cfg.dtype, device=dev)}


def autoint_specs(cfg: CTRConfig) -> dict:
    layer = {"wq": P(None, "model"), "wk": P(None, "model"),
             "wv": P(None, "model"), "wres": P(None, "model")}
    return {"table": P("model", None),
            "attn": [layer] * cfg.n_attn_layers,
            "w_out": P(None, None), "bias": P()}


def autoint_logits(params: dict, ids: torch.Tensor, cfg: CTRConfig
                   ) -> torch.Tensor:
    h = embedding_lookup(params["table"], _global_ids(ids, cfg))  # [B, F, D]
    # on a mesh, a layer's activations whole over model (rows over data):
    # heads unpacked from a split [B, F, heads * d_attn] would split the
    # batched products' batch dim two ways, and their gradients the head
    # dim where the axis does not divide it (DTensor propagates neither)
    split = (lambda t: maybe_shard(t, P("data", None, None))) \
        if mesh_axis_size("model") else (lambda t: t)
    for lp in params["attn"]:
        b, f, _ = h.shape
        h = split(h)
        q = split(h @ lp["wq"]).reshape(b, f, cfg.n_heads, cfg.d_attn)
        k = split(h @ lp["wk"]).reshape(b, f, cfg.n_heads, cfg.d_attn)
        v = split(h @ lp["wv"]).reshape(b, f, cfg.n_heads, cfg.d_attn)
        scores = torch.einsum("bfnd,bgnd->bnfg", q, k) * cfg.d_attn ** -0.5
        probs = torch.softmax(scores.float(), -1).to(h.dtype)
        o = split(torch.einsum("bnfg,bgnd->bfnd", probs, v).reshape(
            b, f, -1))
        h = torch.relu(o + h @ lp["wres"])
    h = maybe_shard(h, P("data", None, None))
    out = h.reshape(ids.shape[0], -1) @ params["w_out"]
    return (out[:, 0] + params["bias"]).float()


# ------------------------------------------------------------------ DIEN ---

def init_dien(generator: torch.Generator, cfg: CTRConfig,
              device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    d, g = cfg.embed_dim, cfg.gru_dim

    def gru(d_in):
        return {"wx": _normal(generator, (d_in, 3 * g), d_in ** -0.5,
                              cfg.dtype, dev),
                "wh": _normal(generator, (g, 3 * g), g ** -0.5, cfg.dtype,
                              dev),
                "b": torch.zeros((3 * g,), dtype=cfg.dtype, device=dev)}

    table = _normal(generator, (cfg.total_vocab, d), 0.01, cfg.dtype, dev)
    gru1, augru = gru(d), gru(g)          # augru consumes gru1's states
    w_attn = _normal(generator, (g, d), g ** -0.5, cfg.dtype, dev)
    ws, bs = _init_mlp(generator, [g + 2 * d, *cfg.mlp_dims, 1], cfg.dtype,
                       dev)
    return {"table": table, "gru1": gru1, "augru": augru, "w_attn": w_attn,
            "mlp_w": ws, "mlp_b": bs,
            "bias": torch.zeros((), dtype=cfg.dtype, device=dev)}


def dien_specs(cfg: CTRConfig) -> dict:
    # GRU params are tiny (3*108 wide, indivisible by the model axis):
    # replicated; the huge item table stays row-sharded
    gru = {"wx": P(None, None), "wh": P(None, None), "b": P(None)}
    return {"table": P("model", None), "gru1": gru, "augru": gru,
            "w_attn": P(None, None),
            "mlp_w": [P(None, None)] * (len(cfg.mlp_dims) + 1),
            "mlp_b": [P(None)] * (len(cfg.mlp_dims) + 1),
            "bias": P()}


def _gru_scan(x: torch.Tensor, p: dict, g: int,
              att: torch.Tensor | None = None) -> torch.Tensor:
    """GRU (att=None) or AUGRU (att [B, S] scales the update gate), a
    Python loop over time.  x: [B, S, D] -> hidden states [B, S, G]."""
    if att is None:
        att = x.new_ones(x.shape[:2])
    h = x.new_zeros((x.shape[0], g))
    ys = []
    for t in range(x.shape[1]):
        gx = x[:, t] @ p["wx"] + p["b"]
        gh = h @ p["wh"]
        r = torch.sigmoid(gx[:, :g] + gh[:, :g])
        z = torch.sigmoid(gx[:, g:2 * g] + gh[:, g:2 * g])
        n = torch.tanh(gx[:, 2 * g:] + r * gh[:, 2 * g:])
        z = z * att[:, t, None]            # AUGRU gate (att=1: plain GRU)
        h = (1 - z) * h + z * n
        ys.append(h)
    return torch.stack(ys, 1)


def dien_logits(params: dict, batch_ids: dict, cfg: CTRConfig
                ) -> torch.Tensor:
    """batch_ids: {"hist": [B, S] item ids (-1 pad), "target": [B]}."""
    hist, target = batch_ids["hist"], batch_ids["target"]
    mask = hist >= 0
    emb_h = embedding_lookup(params["table"], hist.clamp(min=0))
    emb_h = torch.where(mask[..., None], emb_h, 0)          # [B, S, D]
    emb_t = embedding_lookup(params["table"], target)       # [B, D]
    g = cfg.gru_dim
    h1 = _gru_scan(emb_h, params["gru1"], g)                # interest extract
    att = torch.einsum("bsg,gd,bd->bs", h1, params["w_attn"], emb_t)
    att = torch.softmax(torch.where(mask, att, -1e30), -1).to(h1.dtype)
    h2 = _gru_scan(h1, params["augru"], g, att)             # interest evolve
    final = h2[:, -1]                                       # [B, G]
    hist_mean = embedding_bag(params["table"], hist, "mean")
    feat = torch.cat([final, emb_t, hist_mean], -1)
    out = _mlp(feat, params["mlp_w"], params["mlp_b"])[:, 0]
    return (out + params["bias"]).float()


# --------------------------------------------------------------- BERT4Rec --

class Bert4RecConfig(NamedTuple):
    name: str
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    dtype: torch.dtype = torch.float32

    def param_count(self) -> int:
        d = self.embed_dim
        per_block = 4 * d * d + 8 * d * d + 4 * d   # attn + 4d FFN + norms
        return self.n_items * d * 2 + self.seq_len * d \
            + self.n_blocks * per_block


def init_bert4rec(generator: torch.Generator, cfg: Bert4RecConfig,
                  device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    d = cfg.embed_dim
    s = d ** -0.5
    items = _normal(generator, (cfg.n_items, d), s, cfg.dtype, dev)
    pos = _normal(generator, (cfg.seq_len, d), 0.02, cfg.dtype, dev)
    head = _normal(generator, (cfg.n_items, d), s, cfg.dtype, dev)
    blocks = []
    for _ in range(cfg.n_blocks):
        blk = {n: _normal(generator, (d, d), s, cfg.dtype, dev)
               for n in ("wq", "wk", "wv", "wo")}
        blk["w1"] = _normal(generator, (d, 4 * d), s, cfg.dtype, dev)
        blk["w2"] = _normal(generator, (4 * d, d), (4 * d) ** -0.5,
                            cfg.dtype, dev)
        blk["ln1"] = torch.ones((d,), dtype=torch.float32, device=dev)
        blk["ln2"] = torch.ones((d,), dtype=torch.float32, device=dev)
        blocks.append(blk)
    return {"items": items, "pos": pos, "blocks": blocks, "head": head,
            "final_norm": torch.ones((d,), dtype=torch.float32, device=dev)}


def bert4rec_specs(cfg: Bert4RecConfig) -> dict:
    # the encoder is tiny (d = 64): replicated; only the 1M-row item and
    # head tables are sharded
    block = {"wq": P(None, None), "wk": P(None, None),
             "wv": P(None, None), "wo": P(None, None),
             "w1": P(None, None), "w2": P(None, None),
             "ln1": P(None), "ln2": P(None)}
    return {"items": P("model", None), "pos": P(None, None),
            "blocks": [block] * cfg.n_blocks,
            "head": P("model", None), "final_norm": P(None)}


def bert4rec_encode(params: dict, seq: torch.Tensor,
                    cfg: Bert4RecConfig) -> torch.Tensor:
    """seq: int [B, S] item ids (-1 pad) -> hidden [B, S, D].

    Bidirectional attention (cloze objective): the per-position hidden is
    the LSS query against the item-catalogue WOL."""
    mask = seq >= 0
    x = embedding_lookup(params["items"], seq.clamp(min=0)) \
        + params["pos"][None]
    x = torch.where(mask[..., None], x, 0).to(cfg.dtype)
    nh, d = cfg.n_heads, cfg.embed_dim
    hd = d // nh
    for blk in params["blocks"]:
        h = L.rms_norm(x, blk["ln1"])
        b, s, _ = h.shape
        q = (h @ blk["wq"]).reshape(b, s, nh, hd)
        k = (h @ blk["wk"]).reshape(b, s, nh, hd)
        v = (h @ blk["wv"]).reshape(b, s, nh, hd)
        logits = torch.einsum("bqnh,bknh->bnqk", q, k) * hd ** -0.5
        logits = torch.where(mask[:, None, None, :], logits, -1e30)
        probs = torch.softmax(logits.float(), -1).to(x.dtype)
        o = torch.einsum("bnqk,bknh->bqnh", probs, v).reshape(b, s, d)
        x = x + o @ blk["wo"]
        h = L.rms_norm(x, blk["ln2"])
        # jax.nn.gelu's default: the tanh approximation
        x = x + F.gelu(h @ blk["w1"], approximate="tanh") @ blk["w2"]
    return L.rms_norm(x, params["final_norm"])


def bert4rec_loss(params: dict, batch: dict, cfg: Bert4RecConfig
                  ) -> torch.Tensor:
    """Cloze loss. batch: seq [B, S] (-1 pad), labels [B, S] (-1 = unmasked
    position; >= 0 = the held-out item at a masked position)."""
    hidden = bert4rec_encode(params, batch["seq"], cfg)
    labels = batch["labels"].long()
    mask = labels >= 0
    logits = torch.einsum("bsd,vd->bsv", hidden, params["head"]).float()
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return ((logz - gold) * mask).sum() / mask.sum().clamp(min=1)


def retrieval_scores(params: dict, user_hidden: torch.Tensor,
                     candidates: torch.Tensor | None = None) -> torch.Tensor:
    """Score a user embedding against the catalogue (the paper's WOL
    setting).  candidates=None -> the full [B, V] product (the baseline
    LSS beats); ids [C] -> gathered scoring."""
    head = params["head"]
    if candidates is not None:
        head = head[candidates.long()]
    return torch.einsum("bd,vd->bv", user_hidden.float(), head.float())
