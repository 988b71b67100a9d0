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

Each phase of a call is an ``obs`` span: ``step.copy_in`` (its
``pinned`` attribute counts the host buffers it pinned), ``step.replay``
and ``step.clone`` on the card, ``step.copy_in`` and ``step.eager`` on the
CPU.

The score steps bind nothing: their one input is the bucket-shaped
request batch.  The fused decode step binds ``(params, tok, k, v)`` and
copies in the host operands (``lengths``, or ``page_table, lengths``).
It writes the step's KV into the pool's own ``k``/``v`` and the next
tokens into ``tok`` in place, inside the graph: this takes the place of
the JAX package's buffer donation on TPU, and lets steps chain without a
host round trip.  Its warm-up feeds its tokens back too, so ``tok`` is
named in ``restore``: the step puts it back before capturing.  (The
warm-up's KV writes are the values the replay writes again.)

A step may also have a ``post``: ``post(*bound, out)`` runs eagerly
after every call (after the replay and the clone, outside the step's
lock) and its result is the step's.  The vocab-sharded head puts its
merge there: a gloo collective cannot be captured at all, and an NCCL
one captured would bind every rank to replay in the same order, so the
graph ends at the shard-local winners and the gather, the global top-k
and (for a decode step) the ``tok`` write run after it.

Python bodies run only at capture.  A kernel wrapper's ``launches``
counter therefore counts the calls that launched its kernel: the
warm-up's and the one recorded into the graph.  A replay runs the
graph's kernels without calling a wrapper, so replays show on the
device (``torch.profiler``'s kernel events), not in the counters.

Steps are built while the engine serves (an index refresh warms the new
epoch's steps, a decode generation captures its fused step), so a build
stalls nothing but callers of the same step:

* it holds only the step's own lock, never the engine's;
* the capture calls ``CUDAGraph.capture_begin``/``capture_end`` on a
  capture stream of its own, in ``thread_local`` mode, and not
  ``torch.cuda.graph``, whose entry synchronises the device and empties
  the device and pinned host caches (the serving threads' allocations
  would then wait on that, and their next pinned copies allocate anew);
* a step's graph is never destroyed outside ``_CAPTURE_LOCK``: a graph
  destroyed while another thread captures invalidates that capture, so a
  dropped step hands its graph to :func:`release_graphs`, which runs
  under the lock (the engine calls it after each drop, and every capture
  calls it when it ends).
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["Step", "release_graphs"]

# one warm-up stream and one capture stream a device: cuBLAS keeps a
# workspace for each stream it has run on, so a new stream a build would
# leave one behind per build
_WARMUP_STREAMS: dict[int, torch.cuda.Stream] = {}
_CAPTURE_STREAMS: dict[int, torch.cuda.Stream] = {}
_STREAMS_LOCK = threading.Lock()
# captures run one at a time with automatic garbage collection off, and
# graphs are destroyed only under this lock: destroying a graph while a
# capture runs (a collection inside it, or another thread dropping a
# step) invalidates the capture
_CAPTURE_LOCK = threading.Lock()
# the graphs of dropped steps, until release_graphs destroys them
_DEAD: list = []


def _stream(table: dict, device: torch.device) -> torch.cuda.Stream:
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    with _STREAMS_LOCK:
        if index not in table:
            table[index] = torch.cuda.Stream(index)
        return table[index]


def _reap() -> int:
    n = 0
    while _DEAD:
        _DEAD.pop()                 # the last reference: destroyed here
        n += 1
    return n


def release_graphs(block: bool = True) -> int:
    """Destroy the CUDA graphs of dropped steps, under the capture lock.
    ``block=False`` returns at once while a capture runs (the capture
    releases them when it ends).  Returns how many were destroyed."""
    if not _CAPTURE_LOCK.acquire(blocking=block):
        return 0
    try:
        return _reap()
    finally:
        _CAPTURE_LOCK.release()


def _to_device(leaf, device: torch.device) -> torch.Tensor:
    """A request leaf (numpy array or tensor) as a tensor on ``device``."""
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    return torch.from_numpy(np.ascontiguousarray(leaf)).to(device)


def _copy_in(dst: torch.Tensor, src) -> int:
    """Copy one input leaf into its static buffer, asynchronously: a host
    array goes through a pinned buffer (a copy from pageable memory would
    wait for the stream).  Returns the host buffers it pinned (0 or 1)."""
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"input leaf of shape {tuple(src.shape)} does "
                         f"not fit the step's {tuple(dst.shape)}")
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.ascontiguousarray(src))
    pinned = src.device.type == "cpu"
    if pinned:
        src = src.to(dst.dtype).pin_memory()
    dst.copy_(src, non_blocking=True)
    return int(pinned)


class Step:
    """One step: ``fn(*bound, *inputs)`` with the first ``n_bound``
    arguments bound (see the module docstring).  ``restore`` names the
    bound tensors that the warm-up changes and the capture must see as
    they were.  ``on_build`` runs once per build (the engine's
    ``compile_counts``), under the step's own lock: it must take no lock
    that is held while a step is called.  A build that raises is retried
    by the next call, as a JAX trace that fails is.  ``build_s`` is the
    host seconds of the last build (warm-up and capture on the card).
    ``post(*bound, out)``, if given, runs eagerly after each call and
    gives the step's result."""

    def __init__(self, fn: Callable, device: torch.device,
                 on_build: Callable[[], None], *,
                 n_bound: int = 0, restore: tuple[int, ...] = (),
                 post: Callable | None = None):
        self.fn = fn
        self.device = device
        self._on_build = on_build
        self._n_bound = n_bound
        self._restore = restore
        self._post = post
        self._lock = threading.Lock()
        self._built = False
        self.build_s: float | None = None
        self._graph: torch.cuda.CUDAGraph | None = None
        self._bound: tuple = ()
        self._in_leaves: list[torch.Tensor] = []
        self._static_out = None

    def __del__(self):
        # destroyed under _CAPTURE_LOCK (release_graphs), not here: this
        # runs on whichever thread drops the last reference
        graph = getattr(self, "_graph", None)
        if graph is not None and _DEAD is not None:
            _DEAD.append(graph)

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, *args):
        """``fn`` on ``args`` (then ``post``); returns its outputs as
        tensors on the step's device."""
        bound = args[:self._n_bound]
        out = self._run(bound, args[self._n_bound:])
        if self._post is None:
            return out
        with torch.no_grad():
            return self._post(*bound, out)

    def _run(self, bound, inputs):
        if self.device.type != "cuda":
            if not self._built:
                with self._lock:
                    if not self._built:
                        t0 = time.perf_counter()
                        self._on_build()
                        out = self._eager(bound, inputs)
                        self.build_s = time.perf_counter() - t0
                        self._built = True
                        return out
            return self._eager(bound, inputs)
        if self._graph is None:
            with self._lock:
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
            with obs.span("step.copy_in") as s:
                s.set(pinned=sum(_copy_in(dst, src) for dst, src
                                 in zip(self._in_leaves, leaves)))
            with obs.span("step.replay"):
                self._graph.replay()
            with obs.span("step.clone"):
                return tree_map(torch.clone, self._static_out)

    def _eager(self, bound, inputs):
        with obs.span("step.copy_in", pinned=0):
            inputs = tree_map(lambda leaf: _to_device(leaf, self.device),
                              inputs)
        with obs.span("step.eager"), torch.no_grad():
            return self.fn(*bound, *inputs)

    def _capture(self, bound, inputs) -> None:
        t0 = time.perf_counter()
        self._on_build()
        # buffers of the step's own: a caller's device tensor is never a
        # static input (every call's copy-in would overwrite it)
        static_in = tree_map(
            lambda leaf: _to_device(leaf, self.device).clone(), inputs)
        saved = [bound[i].clone() for i in self._restore]
        # warm-up: builds the kernels and cuBLAS's workspace, eagerly
        current = torch.cuda.current_stream(self.device)
        side = _stream(_WARMUP_STREAMS, self.device)
        side.wait_stream(current)
        with torch.no_grad(), torch.cuda.stream(side):
            self.fn(*bound, *static_in)
            for i, value in zip(self._restore, saved):
                bound[i].copy_(value)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        cap = _stream(_CAPTURE_STREAMS, self.device)
        with _CAPTURE_LOCK:
            _reap()
            collecting = gc.isenabled()
            gc.disable()
            try:
                cap.wait_stream(current)
                with torch.no_grad(), torch.cuda.stream(cap):
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        static_out = self.fn(*bound, *static_in)
                    finally:
                        graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
                _reap()
        self.build_s = time.perf_counter() - t0
        self._in_leaves = tree_leaves(static_in)
        self._static_out = static_out
        # held, not just compared: the graph uses these addresses
        self._bound = bound
        self._graph = graph
