"""Useful operations and step bytes of a sparse-expert decoder served with
an LSS head (``mfu.moe``, ``step_roofline.moe``), from its configuration's
published keys.

Operations, per token: 2 a weight of the linear layers the token uses,
which are attention's q, k, v and o, the router over the real experts,
the shared expert and its ``Linear(d, 1)`` gate, and its
``num_experts_per_tok`` routed experts (never the padding); attention at
the token's context (q.k and p.v: 4 * heads * head_dim a position a
layer); and the head: the hash (2*(d+1)*K*L) and 2*(d+1) a scored
candidate.  A prompt of p tokens costs p tokens' linear work, the causal
attention over 1..p, and its last position's head.

Bytes a decode step must read: the attention and shared-expert weights
and the router once; each routed expert that a row of the step picked,
once (``experts_hit``, the distinct experts with a token summed over the
layers, from the step's ``tick`` span); each row's K and V over its
context; and the LSS slab's rows of each row's bucket (float32).  Norms,
biases and the embedding rows are left out, so a bound from these bytes
lies under the time a step takes.
"""

from __future__ import annotations

from wolbench.cost import lm

__all__ = ["expert_bytes", "step_weight_bytes", "kv_bytes_per_position",
           "scored_bytes", "active_linear_params", "decode_token_flops",
           "prefill_flops"]

_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
ROUTER_BYTES = 4           # the port's router is float32
SLAB_BYTES = 4             # the LSS slab is float32 (``lss.slab_dtype``)


def _widths(cfg: dict) -> tuple[int, int, int]:
    d = cfg["hidden_size"]
    hd = cfg.get("head_dim") or d // cfg["num_attention_heads"]
    return d, cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd


def _dense_layer_params(cfg: dict) -> int:
    """A layer's weights outside the routed experts: attention, the router
    over the real experts, the shared expert and its gate."""
    d, nq, nkv = _widths(cfg)
    return (d * nq + 2 * d * nkv + nq * d + d * cfg["num_experts"]
            + 3 * d * cfg["shared_expert_intermediate_size"] + d)


def _expert_params(cfg: dict) -> int:
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def active_linear_params(cfg: dict) -> int:
    """Weights of the linear layers one token uses in all layers."""
    return cfg["num_hidden_layers"] * (
        _dense_layer_params(cfg)
        + cfg["num_experts_per_tok"] * _expert_params(cfg))


def decode_token_flops(cfg: dict, context: int, k_bits: int, n_tables: int,
                       scored: float) -> float:
    """One decoded token that attends over ``context`` positions (its own
    included) and whose head scores ``scored`` candidates."""
    return (2 * active_linear_params(cfg)
            + lm._attn_per_position(cfg) * context
            + lm._head(cfg, k_bits, n_tables, scored))


def prefill_flops(cfg: dict, prompt: int, k_bits: int, n_tables: int,
                  scored: float) -> float:
    """A prompt of ``prompt`` tokens and its first token's head."""
    return (2 * active_linear_params(cfg) * prompt
            + lm._attn_per_position(cfg) * prompt * (prompt + 1) / 2
            + lm._head(cfg, k_bits, n_tables, scored))


def expert_bytes(cfg: dict) -> int:
    """One routed expert's gate, up and down weights."""
    return _expert_params(cfg) * _BYTES[cfg["torch_dtype"]]


def step_weight_bytes(cfg: dict) -> int:
    """What every decode step reads of the weights whatever it routes:
    attention, the shared expert and its gate in the model's type, the
    router in float32, in all layers."""
    d = cfg["hidden_size"]
    router = d * cfg["num_experts"]
    return cfg["num_hidden_layers"] * (
        (_dense_layer_params(cfg) - router) * _BYTES[cfg["torch_dtype"]]
        + router * ROUTER_BYTES)


def kv_bytes_per_position(cfg: dict) -> int:
    """K and V of one position in every layer, in the cache's type."""
    _, _, nkv = _widths(cfg)
    return cfg["num_hidden_layers"] * 2 * nkv * _BYTES[cfg["torch_dtype"]]


def scored_bytes(cfg: dict, scored: float) -> float:
    """The LSS slab's rows a token's bucket holds, ``[w, b]`` each."""
    return scored * (cfg["hidden_size"] + 1) * SLAB_BYTES
