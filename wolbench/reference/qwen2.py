"""Plain reference of a Qwen2 decoder (arXiv:2407.10671; the Hugging Face
``Qwen2ForCausalLM`` definition): token embedding, then per layer
RMSNorm -> grouped-query attention with q/k/v biases and rotary
position embedding on the two halves of each head -> residual, RMSNorm
-> SwiGLU MLP -> residual, and a final RMSNorm.  The output layer is the
embedding (tied), served through an LSS head elsewhere.

One sequence at a time, a layer at a time, attention in blocks of query
rows, all in float32 with TF32 off.  ``precision="fp8"`` is the control:
every linear layer's operands pass through float8 e4m3 first (a scale a
row of the activations and a scale an output channel of the weights),
as an fp8 serving path would compute them; attention and norms stay as
they are.

``params`` is a dict of tensors in the layout the benchmark hands the
program (``embed [V, d]``; ``layers`` with leaves stacked ``[n_layers,
...]``: ``ln1``, ``ln2``, ``wq [d, H*hd]``, ``wk``, ``wv``, ``bq``,
``bk``, ``bv``, ``wo [H*hd, d]``, ``w_gate [d, f]``, ``w_up``,
``w_down [f, d]``; ``final_norm``); each layer is widened to float32
when it is used.
"""

from __future__ import annotations

import torch

from wolbench.reference.common import fp8_rows, no_tf32

__all__ = ["hidden_states"]


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def _linear(x: torch.Tensor, w: torch.Tensor, precision: str
            ) -> torch.Tensor:
    """``x [S, a] @ w [a, b]``."""
    if precision == "fp8":
        return fp8_rows(x) @ fp8_rows(w.float().T).T
    return x @ w.float()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
          ) -> torch.Tensor:
    """Rotate ``x [S, n, hd]``: the first half of each head against the
    second (``rotate_half``)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


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
            h = _rms(x, lay["ln2"][i], eps)
            g = _linear(h, lay["w_gate"][i], precision)
            u = _linear(h, lay["w_up"][i], precision)
            x = x + _linear(torch.nn.functional.silu(g) * u,
                            lay["w_down"][i], precision)
        return _rms(x, params["final_norm"], eps)
