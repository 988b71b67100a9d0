"""The step table's entries: the port's counterpart of ``jax.jit`` for
one (head, bucket) serving step.

A :class:`Step` runs ``fn`` (the engine's ``embed`` then head) on a
bucket-shaped request batch.

* **On the CPU** it runs eagerly.
* **On the card** its first call captures ``fn`` once as a CUDA graph
  (``torch.cuda.CUDAGraph``) over a static input buffer of the bucket's
  shape, after one eager warm-up run on a side stream (the warm-up
  builds the kernels with ``nvcc`` and lets cuBLAS allocate its
  workspace, neither of which may happen inside a capture).  Every call
  then copies the batch into the static input, replays the graph and
  clones the outputs out of the graph's pool, all under the step's own
  lock: two threads replaying one graph would otherwise race on its
  static input.  The clone is an asynchronous device copy, so a later
  replay cannot overwrite a result still in use.

Python bodies run only at capture.  A kernel wrapper's ``launches``
counter therefore counts the calls that launched its kernel: the
warm-up's and the one recorded into the graph.  A replay runs the
graph's kernels without calling a wrapper, so replays show on the
device (``torch.profiler``'s kernel events), not in the counters.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["Step"]

# one warm-up stream a device: cuBLAS keeps a workspace for each stream
# it has run on, so a new stream a build would leave one behind per build
_WARMUP_STREAMS: dict[int, torch.cuda.Stream] = {}
_WARMUP_LOCK = threading.Lock()


def _warmup_stream(device: torch.device) -> torch.cuda.Stream:
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    with _WARMUP_LOCK:
        if index not in _WARMUP_STREAMS:
            _WARMUP_STREAMS[index] = torch.cuda.Stream(index)
        return _WARMUP_STREAMS[index]


def _to_device(leaf, device: torch.device) -> torch.Tensor:
    """A request leaf (numpy array or tensor) as a tensor on ``device``."""
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    return torch.from_numpy(np.ascontiguousarray(leaf)).to(device)


def _copy_in(dst: torch.Tensor, src) -> None:
    """Copy one leaf of a bucket-shaped batch into the static input,
    asynchronously: a host array goes through a pinned buffer (a copy
    from pageable memory would wait for the stream)."""
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"request batch leaf of shape {tuple(src.shape)} "
                         f"does not fit the step's {tuple(dst.shape)}")
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.ascontiguousarray(src))
    if src.device.type == "cpu":
        src = src.to(dst.dtype).pin_memory()
    dst.copy_(src, non_blocking=True)


class Step:
    """One (head, bucket) step.  ``on_build`` runs once per build (the
    engine's ``compile_counts``); a build that raises is retried by the
    next call, as a JAX trace that fails is.  ``build_lock`` is held
    around a capture (the engine's lock, taken before the step's own)."""

    def __init__(self, fn: Callable, device: torch.device,
                 on_build: Callable[[], None],
                 build_lock: threading.RLock | None = None):
        self.fn = fn
        self.device = device
        self._on_build = on_build
        self._build_lock = build_lock or threading.RLock()
        self._lock = threading.Lock()
        self._built = False
        self._graph: torch.cuda.CUDAGraph | None = None
        self._in_leaves: list[torch.Tensor] = []
        self._static_out = None

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, x):
        """``fn`` on the bucket-shaped pytree ``x`` (numpy arrays or
        tensors); returns its outputs as tensors on the step's device."""
        if self.device.type != "cuda":
            if not self._built:
                with self._build_lock:
                    if not self._built:
                        self._on_build()
                        out = self._eager(x)
                        self._built = True
                        return out
            return self._eager(x)
        if self._graph is None:
            with self._build_lock, self._lock:
                if self._graph is None:
                    self._capture(x)
        leaves = tree_leaves(x)
        if len(leaves) != len(self._in_leaves):
            raise ValueError(f"request batch of {len(leaves)} leaves does "
                             f"not fit the step's {len(self._in_leaves)}")
        with self._lock:
            for dst, src in zip(self._in_leaves, leaves):
                _copy_in(dst, src)
            self._graph.replay()
            return tree_map(torch.clone, self._static_out)

    def _eager(self, x):
        with torch.no_grad():
            return self.fn(tree_map(
                lambda leaf: _to_device(leaf, self.device), x))

    def _capture(self, x) -> None:
        self._on_build()
        # a buffer of the step's own: a caller's device tensor is never
        # the static input (every replay's copy-in would overwrite it)
        static_in = tree_map(
            lambda leaf: _to_device(leaf, self.device).clone(), x)
        # warm-up: builds the kernels and cuBLAS's workspace, eagerly
        side = _warmup_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.no_grad(), torch.cuda.stream(side):
            self.fn(static_in)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            static_out = self.fn(static_in)
        self._in_leaves = tree_leaves(static_in)
        self._static_out = static_out
        self._graph = graph

