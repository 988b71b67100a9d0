"""The step table's entries: the port's counterpart of ``jax.jit`` for
one (head, bucket) serving step and for one fused decode step.

A :class:`Step` runs ``fn(*bound, *inputs)``.  ``bound`` are the first
``n_bound`` arguments: tensors (or trees of them) that the step uses as
they are.  ``inputs`` are the rest: pytrees of numpy arrays or tensors.

* **On the CPU** it runs eagerly.
* **On the card** its first call captures ``fn`` once as a CUDA graph
  (``torch.cuda.CUDAGraph``) over static buffers of the step's own that
  hold a copy of ``inputs``, after one eager warm-up run on a side
  stream (the warm-up builds the kernels with ``nvcc`` and lets cuBLAS
  allocate its workspace, neither of which may happen inside a
  capture).  Every call then copies ``inputs`` into the static buffers,
  replays the graph and clones the outputs out of the graph's pool, all
  under the step's own lock: two threads replaying one graph would
  otherwise race on its static buffers.  The clone is an asynchronous
  device copy, so a later replay cannot overwrite a result still in
  use.  The graph holds the addresses of the ``bound`` tensors, so the
  step keeps them and a call must pass the very same ones.

The score steps bind nothing: their one input is the bucket-shaped
request batch.  The fused decode step binds ``(params, tok, k, v)`` and
copies in the host operands (``lengths``, or ``page_table, lengths``).
It writes the step's KV into the pool's own ``k``/``v`` and the next
tokens into ``tok`` in place, inside the graph: this takes the place of
the JAX package's buffer donation on TPU, and lets steps chain without a
host round trip.  Its warm-up feeds its tokens back too, so ``tok`` is
named in ``restore``: the step puts it back before capturing.  (The
warm-up's KV writes are the values the replay writes again.)

Python bodies run only at capture.  A kernel wrapper's ``launches``
counter therefore counts the calls that launched its kernel: the
warm-up's and the one recorded into the graph.  A replay runs the
graph's kernels without calling a wrapper, so replays show on the
device (``torch.profiler``'s kernel events), not in the counters.
"""

from __future__ import annotations

import gc
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
# captures run one at a time with automatic garbage collection off: an
# engine and its steps form a reference cycle, so a dead engine's graphs
# go when the collector runs, and a collection inside a capture would
# destroy a graph there -- which a capturing thread may not do, and which
# invalidates the capture
_CAPTURE_LOCK = threading.Lock()


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
    """Copy one input leaf into its static buffer, asynchronously: a host array goes through a pinned buffer (a copy
    from pageable memory would wait for the stream)."""
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"input leaf of shape {tuple(src.shape)} does "
                         f"not fit the step's {tuple(dst.shape)}")
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.ascontiguousarray(src))
    if src.device.type == "cpu":
        src = src.to(dst.dtype).pin_memory()
    dst.copy_(src, non_blocking=True)


class Step:
    """One step: ``fn(*bound, *inputs)`` with the first ``n_bound``
    arguments bound (see the module docstring).  ``restore`` names the
    bound tensors that the warm-up changes and the capture must see as
    they were.  ``on_build`` runs once per build (the engine's
    ``compile_counts``); a build that raises is retried by the next call,
    as a JAX trace that fails is.  ``build_lock`` is held around a build
    (the engine's lock, taken before the step's own)."""

    def __init__(self, fn: Callable, device: torch.device,
                 on_build: Callable[[], None],
                 build_lock: threading.RLock | None = None, *,
                 n_bound: int = 0, restore: tuple[int, ...] = ()):
        self.fn = fn
        self.device = device
        self._on_build = on_build
        self._build_lock = build_lock or threading.RLock()
        self._n_bound = n_bound
        self._restore = restore
        self._lock = threading.Lock()
        self._built = False
        self._graph: torch.cuda.CUDAGraph | None = None
        self._bound: tuple = ()
        self._in_leaves: list[torch.Tensor] = []
        self._static_out = None

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, *args):
        """``fn`` on ``args``; returns its outputs as tensors on the
        step's device."""
        bound, inputs = args[:self._n_bound], args[self._n_bound:]
        if self.device.type != "cuda":
            if not self._built:
                with self._build_lock:
                    if not self._built:
                        self._on_build()
                        out = self._eager(bound, inputs)
                        self._built = True
                        return out
            return self._eager(bound, inputs)
        if self._graph is None:
            with self._build_lock, self._lock:
                if self._graph is None:
                    self._capture(bound, inputs)
        leaves = tree_leaves(inputs)
        if len(leaves) != len(self._in_leaves):
            raise ValueError(f"inputs of {len(leaves)} leaves do not fit "
                             f"the step's {len(self._in_leaves)}")
        with self._lock:
            if any(a is not b for a, b in zip(bound, self._bound)):
                raise ValueError(
                    "a step's CUDA graph is bound to the tensors it "
                    "captured (a decode step's params, tokens and KV); "
                    "pass the same ones")
            for dst, src in zip(self._in_leaves, leaves):
                _copy_in(dst, src)
            self._graph.replay()
            return tree_map(torch.clone, self._static_out)

    def _eager(self, bound, inputs):
        with torch.no_grad():
            return self.fn(*bound, *tree_map(
                lambda leaf: _to_device(leaf, self.device), inputs))

    def _capture(self, bound, inputs) -> None:
        self._on_build()
        # buffers of the step's own: a caller's device tensor is never a
        # static input (every call's copy-in would overwrite it)
        static_in = tree_map(
            lambda leaf: _to_device(leaf, self.device).clone(), inputs)
        saved = [bound[i].clone() for i in self._restore]
        # warm-up: builds the kernels and cuBLAS's workspace, eagerly
        side = _warmup_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.no_grad(), torch.cuda.stream(side):
            self.fn(*bound, *static_in)
            for i, value in zip(self._restore, saved):
                bound[i].copy_(value)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK:
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.no_grad(), torch.cuda.graph(
                        graph, capture_error_mode="thread_local"):
                    static_out = self.fn(*bound, *static_in)
            finally:
                if collecting:
                    gc.enable()
        self._in_leaves = tree_leaves(static_in)
        self._static_out = static_out
        # held, not just compared: the graph uses these addresses
        self._bound = bound
        self._graph = graph
