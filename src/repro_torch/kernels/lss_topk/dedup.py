"""Cross-table dedup strategies for the ``lss_topk`` candidate set
(counterpart of ``repro.kernels.lss_topk.dedup``).

The fused pass retrieves C = L*P candidate ids per query and keeps
exactly the FIRST occurrence of every non-negative id before top-k.  Two
algorithms give the same boolean mask, selected by the registry strategy
``lss_topk.dedup``:

``quadratic``
    the ``[C, C]`` all-pairs compare: an id survives iff no earlier slot
    holds it.  O(C^2) memory.
``bitonic``
    a bitonic sorting network over (id, original position) pairs, then one
    neighbour compare marks the first occurrence of each id run.  The
    position breaks ties, so the sort is stable and the mask is identical.

Auto-selection: ``quadratic`` up to :func:`dedup_auto_threshold`
candidates (256, the JAX package's CPU crossover; not re-measured on the
GPU), ``bitonic`` beyond.  The CUDA kernel uses one algorithm (a bitonic
sort) for both choices — the strategy still resolves and is logged.
"""

from __future__ import annotations

import os

import torch

from repro_torch.kernels import registry

__all__ = [
    "DEDUP_CHOICES", "DEDUP_ENV_VAR", "AUTO_THRESHOLD_ENV_VAR", "INT32_MAX",
    "dedup_strategy", "resolve_dedup", "dedup_auto_threshold",
    "set_dedup_auto_threshold", "bitonic_sort_by_id_pos",
    "dedup_mask_quadratic", "dedup_mask_bitonic", "sorted_dedup",
]

DEDUP_CHOICES = ("quadratic", "bitonic")
DEDUP_ENV_VAR = "REPRO_LSS_DEDUP"
AUTO_THRESHOLD_ENV_VAR = "REPRO_LSS_DEDUP_AUTO_C"
DEFAULT_AUTO_THRESHOLD = 256

INT32_MAX = 2 ** 31 - 1      # sort sentinel for padded slots

_auto_threshold: int | None = None


def dedup_auto_threshold() -> int:
    """Candidate count above which auto-select switches to bitonic."""
    if _auto_threshold is not None:
        return _auto_threshold
    env = os.environ.get(AUTO_THRESHOLD_ENV_VAR)
    return int(env) if env else DEFAULT_AUTO_THRESHOLD


def set_dedup_auto_threshold(c: int | None) -> None:
    """Pin the auto-select crossover (``None`` restores env/default)."""
    global _auto_threshold
    _auto_threshold = c


def _auto_dedup(n_candidates: int | None = None, **_ctx) -> str:
    if n_candidates is not None and n_candidates > dedup_auto_threshold():
        return "bitonic"
    return "quadratic"


dedup_strategy = registry.kernel_strategy(
    "lss_topk.dedup", DEDUP_CHOICES, env_var=DEDUP_ENV_VAR, auto=_auto_dedup)


def resolve_dedup(requested: str | None, n_candidates: int) -> str:
    """Resolve the dedup algorithm for a C-candidate call (logged as
    ``("lss_topk.dedup", choice)``)."""
    return dedup_strategy.resolve(requested, n_candidates=n_candidates)


def dedup_mask_quadratic(ids: torch.Tensor) -> torch.Tensor:
    """``int32 [..., C] -> bool [..., C]``: True iff ``ids[i] >= 0`` and no
    ``j < i`` holds the same id.  Materialises ``[..., C, C]``."""
    c = ids.shape[-1]
    eq = ids[..., :, None] == ids[..., None, :]
    ar = torch.arange(c, device=ids.device)
    earlier = ar[None, :] < ar[:, None]                  # col < row
    n_earlier = (eq & earlier).sum(-1)
    return (n_earlier == 0) & (ids >= 0)


def _ceil_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n & (n - 1) else max(n, 2)


def _compare_exchange(arrays: tuple[torch.Tensor, ...], j: int, k: int
                      ) -> tuple[torch.Tensor, ...]:
    """One bitonic substage: compare-exchange the elements at XOR-distance
    ``j`` inside stage ``k``, ordering by the (id, pos) key in
    ``arrays[0:2]``.  Partners are exposed by a reshape to
    ``[..., n/(2j), 2, j]``."""
    keys, pos = arrays[0], arrays[1]
    n = keys.shape[-1]
    lead = keys.shape[:-1]

    def halves(a):
        s = a.reshape(lead + (n // (2 * j), 2, j))
        return s[..., 0, :], s[..., 1, :]

    kl, kr = halves(keys)
    pl_, pr = halves(pos)
    blk = torch.arange(n // (2 * j), device=keys.device)
    asc = ((blk * (2 * j)) & k) == 0                      # [n/(2j)]
    asc = asc.reshape((1,) * len(lead) + (n // (2 * j), 1))
    swap = (kl > kr) | ((kl == kr) & (pl_ > pr))
    swap = torch.where(asc, swap, ~swap)

    def merge(a):
        lo, hi = halves(a)
        nlo = torch.where(swap, hi, lo)
        nhi = torch.where(swap, lo, hi)
        return torch.stack([nlo, nhi], dim=-2).reshape(lead + (n,))

    return tuple(merge(a) for a in arrays)


def bitonic_sort_by_id_pos(ids: torch.Tensor, pos: torch.Tensor,
                           *payload: torch.Tensor
                           ) -> tuple[torch.Tensor, ...]:
    """Sort ``(ids, pos, *payload)`` along the last axis ascending by the
    (id, pos) pair with a bitonic network; the last axis is a power of
    two >= 2.  Distinct positions make it a deterministic permutation."""
    n = ids.shape[-1]
    if n < 2 or n & (n - 1):
        raise ValueError(f"bitonic sort needs a power-of-two length, got {n}")
    arrays = (ids, pos) + payload
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            arrays = _compare_exchange(arrays, j, k)
            j //= 2
        k *= 2
    return arrays


def sorted_dedup(ids: torch.Tensor, logits: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Bitonic-sort (id, pos, logit) rows and mark first occurrences.

    ``ids, logits: [..., C]`` -> ``(sorted_ids, sorted_pos, sorted_logits,
    first)`` each ``[..., n]``, n the next power of two: padded slots carry
    ``INT32_MAX`` ids and ``pos >= C`` and are never first.
    """
    c = ids.shape[-1]
    n = _ceil_pow2(c)
    lead = ids.shape[:-1]
    pos = torch.arange(n, dtype=torch.int32, device=ids.device
                       ).expand(lead + (n,))
    if n != c:
        pad = lead + (n - c,)
        ids = torch.cat([ids, ids.new_full(pad, INT32_MAX)], dim=-1)
        logits = torch.cat([logits, logits.new_zeros(pad)], dim=-1)
    sids, spos, slog = bitonic_sort_by_id_pos(ids, pos, logits)
    new_run = torch.cat(
        [torch.ones(lead + (1,), dtype=torch.bool, device=ids.device),
         sids[..., 1:] != sids[..., :-1]], dim=-1)
    first = new_run & (sids >= 0) & (sids != INT32_MAX)
    return sids, spos, slog, first


def dedup_mask_bitonic(ids: torch.Tensor) -> torch.Tensor:
    """First-occurrence mask via the sorting network, scattered back to
    original positions: ``int32 [B, C] -> bool [B, C]``, identical to
    :func:`dedup_mask_quadratic`."""
    bsz, c = ids.shape
    _, spos, _, first = sorted_dedup(ids, torch.zeros_like(ids,
                                                           dtype=torch.float32))
    n = spos.shape[-1]
    mask = torch.zeros((bsz, n), dtype=torch.bool, device=ids.device)
    return mask.scatter_(1, spos.long(), first)[:, :c]
