"""The paper's extreme-classification model (counterpart of
``repro.models.xc``): Embedding(bag, mean) -> ReLU -> WOL.

Input is sparse BoW, multi-hot token ids padded with -1.  ``embed`` — the
layer below the WOL, i.e. the LSS query — is separate from
``logits``/``loss``, so the LSS index plugs in without touching the model.

The functional face the trainer uses — :func:`init_params` and
:func:`loss` over a params dict — runs the module's own math through
``torch.func.functional_call``; :meth:`XCModel.from_params` wraps a
trained dict for ``embed`` and serving.  The dict's keys are the module's
parameter names (``embed_table``, ``w_out``, ``b_out``; the JAX package
calls the first ``embed``).  The embedding's gradient is dense, as JAX's
``take`` gradient is.

Sharded (:func:`param_specs`, under a mesh the trainer makes active), the
input table and the WOL rows are split over ``model`` as the JAX
package splits them: the lookup sums each rank's rows with one
all-reduce of the ``[B, H]`` bag, the logits stay split over their
labels, and the loss reduces the log-sum-exp and the gold logits with
one all-reduce each of the batch's size (the gold logits by the JAX
package's iota-mask sum, which never gathers the logits).  On one device
the same code runs on plain tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.core.topk import topk_lowest_index
from repro_torch.device import resolve_device
from repro_torch.utils.sharding import (P, embedding, logsumexp, maybe_shard,
                                        replicate, vocab_iota)

__all__ = ["XCConfig", "XCModel", "init_params", "param_specs", "loss"]


class XCConfig(NamedTuple):
    name: str
    input_dim: int        # BoW vocabulary
    hidden: int           # 128 in the paper
    output_dim: int       # WOL width (number of labels)
    max_in: int = 64      # max active input features per sample
    max_labels: int = 8   # max labels per sample (padded -1)
    dtype: torch.dtype = torch.float32

    def param_count(self) -> int:
        return self.input_dim * self.hidden + \
            self.output_dim * (self.hidden + 1)


class XCModel(nn.Module):
    """Parameters ``embed [input_dim, H]``, ``w_out [output_dim, H]``,
    ``b_out [output_dim]``, initialised as in the JAX package: N(0, 1)
    scaled by ``input_dim**-0.5`` and ``hidden**-0.5``, bias 0.

    The normals are drawn on ``generator``'s device (a CUDA generator
    fills the 400 MB Delicious-200K table on the card) and the parameters
    live on ``device`` (the GPU unless the caller asks for the CPU).
    """

    def __init__(self, cfg: XCConfig, generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        self.cfg = cfg

        def normal(shape, scale):
            x = torch.randn(shape, generator=generator,
                            device=generator.device) * scale
            return nn.Parameter(x.to(device=dev, dtype=cfg.dtype))

        self.embed_table = normal((cfg.input_dim, cfg.hidden),
                                  cfg.input_dim ** -0.5)
        self.w_out = normal((cfg.output_dim, cfg.hidden), cfg.hidden ** -0.5)
        self.b_out = nn.Parameter(torch.zeros(cfg.output_dim, dtype=cfg.dtype,
                                              device=dev))

    @classmethod
    def from_params(cls, params: dict[str, torch.Tensor],
                    cfg: XCConfig | None = None) -> "XCModel":
        """A model whose parameters share the tensors of ``params`` (no copy,
        no random draw); ``cfg`` defaults to one sized from the tensors."""
        embed, w_out = params["embed_table"], params["w_out"]
        model = cls.__new__(cls)
        nn.Module.__init__(model)
        model.cfg = cfg or XCConfig("params", input_dim=embed.shape[0],
                                    hidden=embed.shape[1],
                                    output_dim=w_out.shape[0],
                                    dtype=embed.dtype)
        for name in ("embed_table", "w_out", "b_out"):
            setattr(model, name, nn.Parameter(params[name].detach()))
        return model

    def embed(self, x_ids: torch.Tensor) -> torch.Tensor:
        """EmbeddingBag(mean) + ReLU over int ``[B, max_in]`` ids, -1 pad:
        the LSS query embedding."""
        mask = (x_ids >= 0)[..., None]
        rows = embedding(self.embed_table, x_ids.clamp(min=0))  # [B, F, H]
        denom = mask.sum(1).clamp(min=1).to(rows.dtype)
        bag = (rows * mask.to(rows.dtype)).sum(1) / denom
        # a row-sharded table gives each rank a partial bag: one all-reduce
        return torch.relu(maybe_shard(bag, P("data", None)))

    def logits(self, x_ids: torch.Tensor) -> torch.Tensor:
        # replicated over model already; the constraint is for the
        # backward: h's gradient, partial over the WOL's row shards, is
        # all-reduced here before the ReLU's backward
        h = maybe_shard(self.embed(x_ids), P("data", None))
        return (h @ self.w_out.T + self.b_out).float()

    def forward(self, x_ids: torch.Tensor) -> torch.Tensor:
        return self.logits(x_ids)

    def loss(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Multi-label softmax CE (uniform over the true labels).
        ``batch``: ``x [B, max_in]``, ``labels [B, max_labels]``, -1 pad."""
        return _multilabel_ce(self.logits(batch["x"]), batch["labels"])

    def predict_topk(self, x_ids: torch.Tensor, k: int = 5) -> torch.Tensor:
        """Top-k label ids of the exact full head, ties to the lower id."""
        return topk_lowest_index(self.logits(x_ids), k)[1]


def _multilabel_ce(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    mask = labels >= 0
    logz = logsumexp(lg, -1, keepdim=True)
    # shardable multi-label gold logits: one iota-mask pass a label slot
    # (stacked along dim 1, not -1: torch 2.11's DTensor took a stack
    # along -1 of [B] pieces split over the batch for a split of dim 1)
    iota = vocab_iota(lg)
    lab = labels.clamp(min=0)
    gold = replicate(torch.stack(
        [torch.where(iota == lab[:, j:j + 1], lg, 0.0).sum(-1)
         for j in range(labels.shape[1])], 1))
    nll = -(gold - logz) * mask
    return (nll.sum(-1) / mask.sum(-1).clamp(min=1)).mean()


def init_params(generator: torch.Generator, cfg: XCConfig,
                device: str | torch.device | None = None
                ) -> dict[str, torch.Tensor]:
    """The parameters of a fresh :class:`XCModel` as a dict of tensors."""
    model = XCModel(cfg, generator, device)
    return {k: p.detach() for k, p in model.named_parameters()}


def param_specs(cfg: XCConfig) -> dict[str, P]:
    """The layout of each parameter on a ``(data, model)`` mesh (JAX's,
    under the port's names)."""
    return {
        "embed_table": P("model", None),   # input vocab sharded
        "w_out": P("model", None),         # WOL rows sharded (LSS shards match)
        "b_out": P("model"),
    }


def loss(params: dict[str, torch.Tensor], batch: dict[str, torch.Tensor],
         cfg: XCConfig) -> torch.Tensor:
    """:meth:`XCModel.loss` with the parameters in ``params`` (gradients
    flow to its tensors)."""
    model = XCModel.from_params(params, cfg)
    return _multilabel_ce(functional_call(model, params, (batch["x"],)),
                          batch["labels"])
