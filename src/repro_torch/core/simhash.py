"""SimHash primitives for LSS (counterpart of ``repro.core.simhash``).

A SimHash code of ``x`` under hyperplanes ``theta`` is the sign pattern
of ``theta^T x``.  Conventions as in the JAX package:

* Neurons are augmented with their bias: ``c_i = [w_i, b_i]``; queries
  with a zero: ``[q, 0]``.
* ``theta`` has shape ``[d_aug, K * L]`` — K bits for each of L tables.
* Bucket ids pack the K sign bits of one table into an int32 in
  ``[0, 2^K)``, bit j weighing ``2^j``; shape ``[..., L]``.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

__all__ = [
    "augment_neurons", "augment_queries", "init_hyperplanes", "unit",
    "hash_bits", "soft_codes", "pack_bits", "bucket_ids",
]


def augment_neurons(w: torch.Tensor, b: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """``[m, d] (+ [m])`` -> ``[m, d+1]`` neurons ``[w_i, b_i]``."""
    if b is None:
        b = torch.zeros(w.shape[0], dtype=w.dtype, device=w.device)
    return torch.cat([w, b[:, None].to(w.dtype)], dim=-1)


def augment_queries(q: torch.Tensor) -> torch.Tensor:
    """``[..., d]`` -> ``[..., d+1]`` queries ``[q, 0]``."""
    return torch.cat([q, q.new_zeros(q.shape[:-1] + (1,))], dim=-1)


def init_hyperplanes(generator: torch.Generator, d_aug: int, k_bits: int,
                     n_tables: int, device: str | torch.device | None = None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """i.i.d. N(0, 1) hyperplanes ``[d_aug, K * L]`` (SimHash init).

    Drawn on ``generator``'s device, then placed on ``device`` (the GPU
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    theta = torch.randn((d_aug, k_bits * n_tables), generator=generator,
                        device=generator.device, dtype=dtype)
    return theta.to(dev)


def unit(x: torch.Tensor) -> torch.Tensor:
    """L2-normalise the hashed vector: ``x / max(|x|, 1e-12)`` in fp32.

    Part of the hash definition (hard buckets are scale-invariant, but the
    tanh relaxation is not); the fused lss_topk kernel repeats it."""
    x = x.float()
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=1e-12)


def hash_bits(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Hard hash bits ``theta^T unit(x) > 0`` -> bool ``[..., K*L]``."""
    return (unit(x) @ theta.float()) > 0


def soft_codes(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Differentiable relaxation ``tanh(theta^T unit(x))`` (paper eq. 1)."""
    return torch.tanh(unit(x) @ theta.float())


def pack_bits(bits: torch.Tensor, k_bits: int, n_tables: int) -> torch.Tensor:
    """Pack bool bits ``[..., K*L]`` into int32 bucket ids ``[..., L]``.

    Bit j of table l is ``bits[..., l*K + j]`` with weight ``2^j``."""
    shaped = bits.reshape(bits.shape[:-1] + (n_tables, k_bits))
    weights = 2 ** torch.arange(k_bits, dtype=torch.int32,
                                device=bits.device)
    return (shaped.to(torch.int32) * weights).sum(-1, dtype=torch.int32)


def bucket_ids(x: torch.Tensor, theta: torch.Tensor, k_bits: int,
               n_tables: int) -> torch.Tensor:
    """``[..., d_aug]`` -> int32 bucket ids ``[..., L]`` in ``[0, 2^K)``."""
    return pack_bits(hash_bits(x, theta), k_bits, n_tables)
