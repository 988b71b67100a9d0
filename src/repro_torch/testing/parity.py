"""Assertions of the port's parity contract (numpy and torch only).

* Integer outputs (bucket ids, table ids, candidate ids, sample sizes)
  are exact — on the rows where the hash margin holds: a hash bit may
  flip where ``|theta^T x_hat|`` is within rounding of 0, so rows whose
  smallest margin is at or below ``eps`` are excluded (and counted).
* fp32 values are allclose with a tolerance stated by the caller.
* Top ids are exact where neighbouring top logits differ by more than the
  logit tolerance (a near-tie may order either way).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_numpy", "hash_margin", "margin_rows", "assert_ints_equal",
           "assert_close", "assert_topk_ids_equal"]


def to_numpy(x) -> np.ndarray:
    """Tensor (any device; bf16 widened to fp32) or array -> numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def hash_margin(x, theta) -> np.ndarray:
    """Per row, ``min_j |unit(x) @ theta[:, j]|`` in float64: ``[B]``."""
    x = to_numpy(x).astype(np.float64)
    x = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    return np.abs(x @ to_numpy(theta).astype(np.float64)).min(axis=-1)


def margin_rows(x, theta, eps: float = 1e-5) -> np.ndarray:
    """Bool ``[B]``: rows whose hash margin is above ``eps``."""
    return hash_margin(x, theta) > eps


def assert_ints_equal(actual, expected, rows: np.ndarray | None = None,
                      what: str = "") -> None:
    """Exact equality, on ``rows`` only when given."""
    a, e = to_numpy(actual), to_numpy(expected)
    if a.shape != e.shape:
        raise AssertionError(f"{what}: shape {a.shape} != {e.shape}")
    if rows is not None:
        a, e = a[rows], e[rows]
    bad = np.argwhere(a != e)
    if len(bad):
        raise AssertionError(f"{what}: {len(bad)} of {a.size} differ, first "
                             f"at {tuple(bad[0])}: {a[tuple(bad[0])]} != "
                             f"{e[tuple(bad[0])]}")


def assert_close(actual, expected, *, rtol: float, atol: float,
                 rows: np.ndarray | None = None, what: str = "") -> float:
    """``allclose``; returns the largest absolute difference."""
    a = to_numpy(actual).astype(np.float64)
    e = to_numpy(expected).astype(np.float64)
    if a.shape != e.shape:
        raise AssertionError(f"{what}: shape {a.shape} != {e.shape}")
    if rows is not None:
        a, e = a[rows], e[rows]
    err = float(np.max(np.abs(a - e), initial=0.0))
    if not np.allclose(a, e, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: max |diff| {err:.3e} beyond "
                             f"rtol={rtol}, atol={atol}")
    return err


def assert_topk_ids_equal(actual_ids, expected_ids, expected_logits,
                          tol: float, rows: np.ndarray | None = None,
                          next_logit=None, what: str = "") -> int:
    """Exact top ids wherever a slot's logit differs from both neighbours'
    by more than ``tol``.  ``next_logit [B]``, when given, is the (k+1)-th
    logit, so that a near-tie at the k-th slot is excused too.  Returns
    the number of slots checked."""
    ids_a, ids_e = to_numpy(actual_ids), to_numpy(expected_ids)
    lg = to_numpy(expected_logits).astype(np.float64)
    if next_logit is not None:
        nxt = to_numpy(next_logit).astype(np.float64).reshape(-1, 1)
    else:
        nxt = np.full((lg.shape[0], 1), -np.inf)
    ext = np.concatenate([np.full((lg.shape[0], 1), np.inf), lg, nxt], 1)
    apart = (np.abs(ext[:, 1:-1] - ext[:, :-2]) > tol) & \
            (np.abs(ext[:, 1:-1] - ext[:, 2:]) > tol)
    # masked slots (NEG_INF) all carry id -1, so they compare equal anyway
    check = apart | (lg <= -1e29)
    if rows is not None:
        check &= rows[:, None]
    bad = np.argwhere(check & (ids_a != ids_e))
    if len(bad):
        r, j = bad[0]
        raise AssertionError(f"{what}: {len(bad)} top ids differ, first at "
                             f"({r}, {j}): {ids_a[r, j]} != {ids_e[r, j]}")
    return int(check.sum())
