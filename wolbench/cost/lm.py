"""Useful operations of a decoder served with an LSS head (``mfu.reason``, ``mfu.chat``).

Per token: 2 operations a weight of every linear layer (the non-embedding
parameters), attention at the token's context (q.k and p.v: 4 * heads *
head_dim a position a layer), and the head: the hash (2*(d+1)*K*L) and
2*(d+1) a scored candidate.  A prompt of p tokens costs p tokens' linear
work and the causal attention over 1..p, and its last position's head.
"""

from __future__ import annotations

__all__ = ["linear_params", "decode_token_flops", "prefill_flops"]


def linear_params(cfg: dict) -> int:
    """Weights of the linear layers of all layers (embedding, norms and
    biases left out)."""
    d = cfg["hidden_size"]
    hd = cfg.get("head_dim") or d // cfg["num_attention_heads"]
    nq = cfg["num_attention_heads"] * hd
    nkv = cfg["num_key_value_heads"] * hd
    per_layer = d * nq + 2 * d * nkv + nq * d + 3 * d * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * per_layer


def _attn_per_position(cfg: dict) -> int:
    d = cfg["hidden_size"]
    hd = cfg.get("head_dim") or d // cfg["num_attention_heads"]
    return 4 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] * hd


def _head(cfg: dict, k_bits: int, n_tables: int, scored: float) -> float:
    d_aug = cfg["hidden_size"] + 1
    return 2 * d_aug * k_bits * n_tables + 2 * d_aug * scored


def decode_token_flops(cfg: dict, context: int, k_bits: int, n_tables: int,
                       scored: float) -> float:
    """One decoded token that attends over ``context`` positions (its own
    included) and whose head scores ``scored`` candidates."""
    return (2 * linear_params(cfg) + _attn_per_position(cfg) * context
            + _head(cfg, k_bits, n_tables, scored))


def prefill_flops(cfg: dict, prompt: int, k_bits: int, n_tables: int,
                  scored: float) -> float:
    """A prompt of ``prompt`` tokens and its first token's head."""
    return (2 * linear_params(cfg) * prompt
            + _attn_per_position(cfg) * prompt * (prompt + 1) / 2
            + _head(cfg, k_bits, n_tables, scored))
