"""The paper's RNN language model (Appendix B.2; counterpart of
``repro.models.lstm``): embed -> 2x LSTM(200) -> dropout -> WOL.

Functional, over a params dict with the JAX package's names and layout
(``embed``, ``layers``: ``wx``, ``wh``, ``b`` stacked over layers,
``w_out``, ``b_out``), so that :func:`init_params` and :func:`loss` give
the trainer the face ``models/xc.py`` gives it.  The cells run as a
Python loop over time, gates in JAX's order i, f, g, o.  Dropout draws
from a ``torch.Generator`` where JAX takes a key.

:func:`param_specs` lays the leaves out on a ``(data, model)`` mesh as
JAX does: the vocab rows of ``embed`` and of the WOL, and the gate
columns of each cell, over ``model``.  Under a mesh the cell gathers a
step's ``[B, 4H]`` gates (every rank needs all four gates of a hidden
unit), the lookup sums the rank's rows with one all-reduce, and the loss
reduces its log-sum-exp and gold logits over the vocab shards with one
all-reduce each (the gold logit by JAX's iota-mask sum).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.utils.sharding import (P, embedding, is_dtensor, logsumexp,
                                        maybe_shard, place, replicate,
                                        vocab_iota)

__all__ = ["LSTMConfig", "init_params", "param_specs", "embed_seq", "loss"]


class LSTMConfig(NamedTuple):
    name: str
    vocab: int
    hidden: int = 200
    n_layers: int = 2
    dropout: float = 0.2
    dtype: torch.dtype = torch.float32

    def param_count(self) -> int:
        per_layer = 4 * self.hidden * (2 * self.hidden + 1)
        return self.vocab * self.hidden * 2 + self.n_layers * per_layer \
            + self.vocab


def init_params(generator: torch.Generator, cfg: LSTMConfig,
                device: str | torch.device | None = None
                ) -> dict[str, torch.Tensor | dict[str, torch.Tensor]]:
    """N(0, 1) x ``hidden**-0.5`` for ``embed [V, H]``, ``w_out [V, H]``
    and each layer's ``wx``, ``wh [H, 4H]``; zero biases.  Drawn on
    ``generator``'s device, placed on ``device`` (the GPU unless the caller
    asks for the CPU)."""
    dev = resolve_device(device)
    h, v, n = cfg.hidden, cfg.vocab, cfg.n_layers
    s = h ** -0.5

    def normal(*shape):
        x = torch.randn(shape, generator=generator,
                        device=generator.device) * s
        return x.to(device=dev, dtype=cfg.dtype)

    embed, w_out = normal(v, h), normal(v, h)
    layers = {"wx": normal(n, h, 4 * h), "wh": normal(n, h, 4 * h),
              "b": torch.zeros((n, 4 * h), dtype=cfg.dtype, device=dev)}
    return {"embed": embed, "layers": layers, "w_out": w_out,
            "b_out": torch.zeros(v, dtype=cfg.dtype, device=dev)}


def param_specs(cfg: LSTMConfig) -> dict:
    return {
        "embed": P("model", None),
        "layers": {"wx": P(None, None, "model"),
                   "wh": P(None, None, "model"),
                   "b": P(None, "model")},
        "w_out": P("model", None),
        "b_out": P("model"),
    }


def _lstm_layer(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """``[B, S, H] -> [B, S, H]``, one cell a time step."""
    seq = x.shape[1]
    hp = torch.zeros_like(x[:, 0])
    cp = torch.zeros_like(x[:, 0])
    ys = []
    for t in range(seq):
        gates = maybe_shard(x[:, t] @ wx + hp @ wh + b, P("data", None))
        i, f, g, o = gates.chunk(4, dim=-1)
        cp = torch.sigmoid(f) * cp + torch.sigmoid(i) * torch.tanh(g)
        hp = torch.sigmoid(o) * torch.tanh(cp)
        ys.append(hp)
    return torch.stack(ys, dim=1)


def embed_seq(params: dict, tokens: torch.Tensor, cfg: LSTMConfig,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """tokens ``[B, S]`` -> last-layer hidden states ``[B, S, H]`` (the LSS
    query at each position).  With a ``generator``, inverted dropout at
    ``cfg.dropout``: each unit kept with probability ``1 - dropout`` and
    scaled by its inverse."""
    x = maybe_shard(embedding(params["embed"], tokens), P("data", None, None))
    lay = params["layers"]
    for i in range(cfg.n_layers):
        x = _lstm_layer(x, lay["wx"][i], lay["wh"][i], lay["b"][i])
    if generator is not None and cfg.dropout > 0:
        keep = torch.rand(x.shape, generator=generator,
                          device=generator.device) < 1 - cfg.dropout
        # every rank draws the whole mask and keeps its rows
        keep = (place(keep, x.device_mesh, x.placements)
                if is_dtensor(x) else keep.to(x.device))
        x = torch.where(keep, x / (1 - cfg.dropout), torch.zeros_like(x))
    return x


def loss(params: dict, batch: dict[str, torch.Tensor], cfg: LSTMConfig,
         generator: torch.Generator | None = None) -> torch.Tensor:
    """Next-token cross entropy, mean over the positions whose label is
    >= 0.  ``batch``: ``tokens`` and ``labels``, int ``[B, S]``."""
    h = embed_seq(params, batch["tokens"], cfg, generator)
    lg = (torch.einsum("bsh,vh->bsv", h, params["w_out"])
          + params["b_out"]).float()
    labels = batch["labels"]
    mask = labels >= 0
    logz = logsumexp(lg, -1)
    iota = vocab_iota(lg)
    gold = replicate(torch.where(iota == labels.clamp(min=0)[..., None], lg,
                                 0.0).sum(-1))
    return ((logz - gold) * mask).sum() / mask.sum().clamp(min=1)
