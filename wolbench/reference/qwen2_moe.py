"""Plain reference of a Qwen2-MoE decoder (Qwen1.5-MoE-A2.7B; the Hugging
Face ``Qwen2MoeForCausalLM`` definition, model type ``qwen2_moe``): token
embedding, then per layer RMSNorm -> grouped-query attention with q/k/v
biases and rotary position embedding on the two halves of each head ->
residual, RMSNorm -> the sparse block -> residual, and a final RMSNorm.
The output layer (``lm_head``, untied) is served through an LSS head
elsewhere.

The sparse block (``Qwen2MoeSparseMoeBlock``), in every layer
(``decoder_sparse_step`` 1, no ``mlp_only_layers``):

* the router's logits over the ``num_experts`` experts, a softmax, and
  the ``num_experts_per_tok`` most probable experts;
* their probabilities weight the experts' outputs as the softmax gave
  them (``norm_topk_prob`` false), or divided by their sum (true);
* each expert is a SwiGLU of width ``moe_intermediate_size``, run on
  exactly the tokens routed to it: a loop over the experts, with no
  capacity, so no token is dropped;
* one shared SwiGLU expert of width ``shared_expert_intermediate_size``,
  scaled by ``sigmoid(h @ w)`` (a ``Linear(d, 1)``), is added to the
  routed sum.

One sequence at a time, a layer at a time, attention in blocks of query
rows, all in float32 with TF32 off.  Where this departs from Hugging
Face's code: the router's logits are float32 products of float32
operands (Hugging Face's gate is a linear layer in the model's type,
bf16, with the softmax in float32); ties among the top-k probabilities
go to the lower expert (a stable sort, as the port's picker breaks
them; ``torch.topk``, which Hugging Face calls, promises no order on
ties, which random weights make improbable).

``precision="fp8"`` is the control: every linear layer's operands pass
through float8 e4m3 first (a scale a row of the activations and a scale
an output channel of the weights), the attention projections', the
experts' and the shared expert's, as an fp8 serving path would compute
them.  The router and the shared expert's gate, the two linear layers
that pick and scale the experts, stay float32, as fp8 serving paths
keep them; a control that rounded them too would only read further
from the reference.  Attention and norms stay as they are.

``params`` is a dict of tensors in the layout the benchmark hands the
program (``embed [V, d]``, ``lm_head [V, d]``; ``layers`` with leaves
stacked ``[n_layers, ...]``: ``ln1``, ``ln2``, ``wq [d, H*hd]``, ``wk``,
``wv``, ``bq``, ``bk``, ``bv``, ``wo [H*hd, d]``; ``moe``: ``router [d,
E_p]``, ``w_gate [E_p, d, f]``, ``w_up``, ``w_down [E_p, f, d]``, whose
experts from ``num_experts`` on are the program's padding and are never
read here; ``sh_gate [d, f_s]``, ``sh_up``, ``sh_down [f_s, d]``,
``sh_gate_w [d, 1]``; ``final_norm``); each weight is widened to
float32 when it is used.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wolbench.reference.common import no_tf32
from wolbench.reference.qwen2 import _linear, _rms, _rope

__all__ = ["hidden_states", "sparse_block"]


def _swiglu(x, w_gate, w_up, w_down, precision: str) -> torch.Tensor:
    return _linear(F.silu(_linear(x, w_gate, precision))
                   * _linear(x, w_up, precision), w_down, precision)


def sparse_block(h: torch.Tensor, lay: dict, i: int, cfg: dict,
                 precision: str = "float32") -> torch.Tensor:
    """Layer ``i``'s sparse block on the normed rows ``h [S, d]`` (float32):
    the routed experts' weighted sum plus the gated shared expert."""
    moe = lay["moe"]
    n_e, top_k = cfg["num_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(h @ moe["router"][i][:, :n_e].float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]
    if cfg["norm_topk_prob"]:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(n_e):
        rows, slot = torch.nonzero(top_e == e, as_tuple=True)
        if rows.numel():
            y = _swiglu(h[rows], moe["w_gate"][i, e], moe["w_up"][i, e],
                        moe["w_down"][i, e], precision)
            out.index_add_(0, rows, y * top_p[rows, slot, None])
    shared = _swiglu(h, lay["sh_gate"][i], lay["sh_up"][i],
                     lay["sh_down"][i], precision)
    gate = torch.sigmoid(h @ lay["sh_gate_w"][i].float())
    return out + gate * shared


def hidden_states(params: dict, tokens: torch.Tensor, cfg: dict,
                  precision: str = "float32", q_block: int = 1024
                  ) -> torch.Tensor:
    """Final-norm hidden states ``[S, d]`` (float32) of one sequence of
    token ids ``[S]``; position i sees tokens 0..i."""
    d = cfg["hidden_size"]
    n_h = cfg["num_attention_heads"]
    n_kv = cfg["num_key_value_heads"]
    hd = d // n_h
    eps = cfg["rms_norm_eps"]
    dev = params["embed"].device
    tokens = tokens.to(dev).long()
    s = tokens.shape[0]
    pos = torch.arange(s, device=dev, dtype=torch.float64)
    inv = 1.0 / cfg["rope_theta"] ** (
        torch.arange(0, hd, 2, device=dev, dtype=torch.float64) / hd)
    ang = pos[:, None] * inv[None]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    causal = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    lay = params["layers"]
    with no_tf32(), torch.no_grad():
        x = params["embed"][tokens].float()
        for i in range(cfg["num_hidden_layers"]):
            h = _rms(x, lay["ln1"][i], eps)
            q = _linear(h, lay["wq"][i], precision) + lay["bq"][i].float()
            k = _linear(h, lay["wk"][i], precision) + lay["bk"][i].float()
            v = _linear(h, lay["wv"][i], precision) + lay["bv"][i].float()
            q = _rope(q.reshape(s, n_h, hd), cos, sin)
            k = _rope(k.reshape(s, n_kv, hd), cos, sin)
            v = v.reshape(s, n_kv, hd)
            group = n_h // n_kv
            # [KV, group, S, hd] queries against [KV, S, hd] keys
            qg = q.reshape(s, n_kv, group, hd).permute(1, 2, 0, 3)
            kt = k.permute(1, 2, 0)                        # [KV, hd, S]
            vt = v.permute(1, 0, 2)                        # [KV, S, hd]
            att = torch.empty_like(qg)
            for r in range(0, s, q_block):
                logits = (qg[:, :, r:r + q_block] @ kt[:, None]) * hd ** -0.5
                logits = logits.masked_fill(~causal[r:r + q_block], -torch.inf)
                att[:, :, r:r + q_block] = torch.softmax(logits, dim=-1) \
                    @ vt[:, None]
            att = att.permute(2, 0, 1, 3).reshape(s, n_h * hd)
            x = x + _linear(att, lay["wo"][i], precision)
            x = x + sparse_block(_rms(x, lay["ln2"][i], eps), lay, i, cfg,
                                 precision)
        return _rms(x, params["final_norm"], eps)
