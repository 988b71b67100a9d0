"""Weights and hyperplanes made from the seed, on the device, one call a
leaf, in the type they are served in.  The same tensors go to the
program and to the reference."""

from __future__ import annotations

import torch

__all__ = ["generator", "xc_weights", "lm_weights", "hyperplanes"]


def generator(device: torch.device, seed: int, stream: int
              ) -> torch.Generator:
    """A generator on ``device`` for one stream of the run's seed."""
    return torch.Generator(device).manual_seed(
        (int(seed) * 1_000_003 + stream) % 2 ** 63)


def _normal(g: torch.Generator, shape, std: float, dtype: torch.dtype,
            device: torch.device, mean: float = 0.0) -> torch.Tensor:
    x = torch.randn(shape, generator=g, device=device, dtype=dtype)
    return x.mul_(std).add_(mean) if (std != 1.0 or mean) else x


def xc_weights(cfg: dict, seed: int, device: torch.device) -> dict:
    """``embed_table [input_dim, hidden]``, ``w_out [output_dim, hidden]``,
    ``b_out [output_dim]``, float32 (the XC model's parameter names)."""
    g = generator(device, seed, 0)
    init, f32 = cfg["init"], torch.float32
    return {
        "embed_table": _normal(g, (cfg["input_dim"], cfg["hidden"]),
                               init["embed_std"], f32, device),
        "w_out": _normal(g, (cfg["output_dim"], cfg["hidden"]),
                         init["w_std"], f32, device),
        "b_out": _normal(g, (cfg["output_dim"],), init["b_std"], f32,
                         device),
    }


def lm_weights(cfg: dict, seed: int, device: torch.device) -> dict:
    """A decoder's parameters in the port's layout: ``embed``,
    ``final_norm`` and ``layers`` (each leaf stacked over the layers);
    bf16 but the norm scales (float32)."""
    g = generator(device, seed, 0)
    init = cfg["init"]
    n, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    f = cfg["intermediate_size"]
    hd = cfg["head_dim"]
    nq, nkv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    bf, f32 = torch.bfloat16, torch.float32

    def proj(shape):
        return _normal(g, shape, shape[-2] ** -0.5, bf, device)

    def norm(shape):
        return _normal(g, shape, init["norm_std"], f32, device, mean=1.0)

    layers = {
        "ln1": norm((n, d)), "ln2": norm((n, d)),
        "wq": proj((n, d, nq)), "wk": proj((n, d, nkv)),
        "wv": proj((n, d, nkv)), "wo": proj((n, nq, d)),
        "bq": _normal(g, (n, nq), init["bias_std"], bf, device),
        "bk": _normal(g, (n, nkv), init["bias_std"], bf, device),
        "bv": _normal(g, (n, nkv), init["bias_std"], bf, device),
        "w_gate": proj((n, d, f)), "w_up": proj((n, d, f)),
        "w_down": proj((n, f, d)),
    }
    return {"embed": _normal(g, (cfg["vocab_size"], d), init["embed_std"],
                             bf, device),
            "layers": layers, "final_norm": norm((d,))}


def hyperplanes(d_aug: int, k_bits: int, n_tables: int, seed: int,
                device: torch.device) -> torch.Tensor:
    """SimHash hyperplanes ``[d+1, K*L]``, N(0, 1), float32."""
    return torch.randn((d_aug, k_bits * n_tables),
                       generator=generator(device, seed, 1), device=device)
