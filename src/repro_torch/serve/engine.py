"""Unified batched serving engine for WOL inference (counterpart of
``repro.serve.engine``'s score path).

One :class:`Engine` owns:

  * the frozen model body (``embed_fn``) and WOL parameters ``w, b``,
  * a fitted :class:`LSSIndex`, held in an index epoch (plus its
    vocab-sharded form, built lazily),
  * a pluggable head per request — ``full`` | ``lss`` | ``lss-sharded``
    — see ``serve.heads``,
  * a continuous micro-batcher that coalesces submitted requests into
    fixed bucketed batch shapes (``serve.batcher``) so arrival patterns
    never trigger a new build: exactly one step per (head, bucket) pair,
    build counts exposed via ``compile_counts``.  On the card a step is
    a captured CUDA graph (``serve.step``), on the CPU an eager call,
  * first-class serving metrics — p50/p95/p99 latency, throughput, avg
    sample size, label recall — computed from the SAME retrieval pass
    that produced the ranking (no second ``retrieve`` call).

Request flow::

    engine.submit(x, labels=...)   # enqueue one example
    engine.flush()                 # coalesce -> bucketed steps
    engine.metrics()               # ServeMetrics snapshot

The decode path shares the engine: ``decode_logits`` builds one fused
decode step per (head, pool tag) — the model's pooled or paged body
straight into the head, a CUDA graph on the card — and ``LMDecoder``
serves an LM through it (``repro_torch.serve.decode``).  A decode
generation pins the index epoch it started under (``pin_epoch``).

Online refresh (``repro_torch.serve.refresh``) goes through the epoch
table: ``swap_index`` registers a new epoch, ``warm_epoch`` captures its
LSS score steps off the serving path (a build holds the step's own lock,
never ``self.lock``), and ``_swap_prepared`` flips the serving epoch in
O(1) under the lock.  The steps of the epochs a flip or an unpin drops
are released through ``serve.step.release_graphs``, never inside
another thread's capture.  Everything runs on the current stream of the
calling thread: a refit on the default stream queues in order with the
serving replays there, so the new index's tensors need no hand-over.

The vocab-sharded head runs over a ``distributed.ServingMesh``: its
step's graph ends at this rank's shard-local winners, and the gather,
the global top-k and the sample-size sum run after the replay
(``serve.step``'s ``post``).  ``spmd`` (a
``serve.multihost.MultihostContext``) serves it from a fleet of
processes: the leader's steps ship their batch to the followers first
(``multihost.make_leader_step``), followers replay the leader's opcodes
in ``multihost.follower_loop``.

``WOLServer`` remains as a thin compatibility wrapper.  Requests are
pytrees (``{"x": ids}``) of numpy arrays or tensors, as in JAX.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import simhash
from repro_torch.core.iul import fit_lss
from repro_torch.core.lss import LSSConfig, LSSIndex, build_index
from repro_torch.device import HostOutput
from repro_torch.distributed import make_serving_mesh
from repro_torch.obs.audit import RecallAuditor
from repro_torch.serve.batcher import DEFAULT_BUCKETS, MicroBatcher
from repro_torch.serve.heads import (HEAD_KINDS, HeadOutput, make_full_head,
                                     make_lss_head, make_multihost_lss_head,
                                     make_sharded_lss_head, shard_index)
from repro_torch.serve.step import Step, release_graphs
from repro_torch.testing import faults
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["Engine", "ServeMetrics", "RankResult", "WOLServer", "LMDecoder",
           "host_numpy", "stack_rows"]


class ServeMetrics(NamedTuple):
    """Serving metrics window.  The first three fields keep the legacy
    (n_requests, wall_s, avg_sample_size) positional layout."""

    n_requests: int
    wall_s: float
    avg_sample_size: float
    throughput_rps: float
    latency_p50_ms: float
    latency_p95_ms: float
    latency_p99_ms: float
    label_recall: float          # nan until labels are supplied
    n_compiles: int


class RankResult(NamedTuple):
    """Per-request result handed back by ``flush``."""

    rid: int
    logits: np.ndarray           # [k]
    ids: np.ndarray              # [k]


class _Pending(NamedTuple):
    rid: int
    x: Any                       # example pytree (no batch dim, numpy)
    labels: np.ndarray | None    # [NL] int, -1 padded
    t_submit: float


class _IndexEpoch:
    """One fitted-index generation and everything derived from it: its
    LSS heads and steps.  ``swap_index`` prepares a new generation, warms
    its steps off the serving path and flips ``Engine.index_epoch`` to it
    in O(1) under the lock.  Old generations stay resident while decode
    sessions that prefilled under them are still draining (``pins``) and
    are dropped at unpin or at the next swap once unpinned."""

    __slots__ = ("epoch", "index", "heads", "sharded", "steps", "pins")

    def __init__(self, epoch: int, index: LSSIndex):
        self.epoch = epoch
        self.index = index
        self.heads: dict[str, Callable] = {}      # lss kinds only
        self.sharded = None       # (index_stack, w_stack, m_local)
        self.steps: dict[tuple[str, Any], Step] = {}
        self.pins = 0             # decode generations holding this epoch


def host_numpy(leaf) -> np.ndarray:
    """A request leaf as a numpy array (a tensor is copied to the host)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def stack_rows(xs: list) -> Any:
    """Stack per-request pytrees (no batch dim) into one batch pytree."""
    return tree_map(lambda *rows: np.stack(rows), xs[0], *xs[1:])


def _as_label_row(labels) -> np.ndarray | None:
    if labels is None:
        return None
    return np.atleast_1d(np.asarray(host_numpy(labels), np.int32))


def _pad_to_bucket(x, bucket: int):
    """Pad axis 0 of every leaf to ``bucket`` rows with zeros (numpy
    leaves on the host, tensors on their device)."""
    def pad(leaf):
        if not isinstance(leaf, torch.Tensor):
            return MicroBatcher.pad_rows(leaf, bucket)
        n = leaf.shape[0]
        if n == bucket:
            return leaf
        return torch.cat([leaf, leaf.new_zeros((bucket - n,)
                                               + tuple(leaf.shape[1:]))])
    return tree_map(pad, x)


class Engine:
    """Batched WOL serving with a pluggable head.

    ``embed_fn(batch) -> [B, d]`` maps a request batch (a pytree of
    tensors on the engine's device) to query embeddings; pass None when
    requests already ARE embeddings.  ``w [m, d]``, ``b [m]`` are the
    WOL parameters; the engine runs on their device, and the kernel
    registry picks each op's implementation by that device.

    ``mesh`` (a ``distributed.ServingMesh``; default: the fleet's, from
    ``distributed.make_serving_mesh``, or one process holding one shard)
    lays out the ``lss-sharded`` head.  ``spmd`` (a
    ``serve.multihost.MultihostContext``) runs that head over the
    multi-process (host, model) mesh: this rank builds the head's shards
    from only its own rows of W, and — on the leader — every step is
    wrapped to ship its opcode and batch first, so followers sitting in
    ``multihost.follower_loop`` enter the same collectives.  Admission
    (``submit``/``rank``/the AsyncRuntime) happens on the leader only;
    the wrapped seam is ``_step``, which both the sync paths and the
    runtime dispatcher fetch from.  As in the JAX engine, every rank
    still holds the whole W and bias-augmented W (the ``full`` head, the
    fits and the refresher read them) and each epoch's whole index (a
    follower rebuilds it at every swap) beside its shards, so a rank's
    memory does not shrink with the fleet.

    Thread safety: every mutation of engine state — the pending request
    queue, finished results, the metrics window, and the step table —
    happens under ``self.lock`` (an RLock), so one Engine can be shared
    by the AsyncRuntime's worker threads and any number of user threads.
    A step's build and replay hold only the step's own lock (a build
    bumps ``compile_counts`` under a lock of its own), so a capture off
    the serving path stalls no ``submit`` or ``_record``.
    """

    def __init__(self, embed_fn: Callable | None, w: torch.Tensor,
                 b: torch.Tensor | None = None,
                 lss_cfg: LSSConfig = LSSConfig(), *,
                 top_k: int = 5, head: str = "lss",
                 buckets=DEFAULT_BUCKETS, mesh=None,
                 audit_rate: float | None = None, spmd=None):
        if head not in HEAD_KINDS:
            raise ValueError(f"head must be one of {HEAD_KINDS}, got {head}")
        if spmd is not None and embed_fn is not None:
            # fail here, not inside the hot step: the opcode channel ships
            # raw [B, d] float32 embedding batches
            raise ValueError(
                "multihost serving (spmd=...) requires embed_fn=None: "
                "requests must already be [B, d] embeddings; run the "
                "model body before submission")
        self.embed_fn = embed_fn
        self.w = w.detach().float()
        self.device = self.w.device
        self.b = (torch.zeros(w.shape[0], device=self.device) if b is None
                  else b.detach().float())
        self.lss_cfg = lss_cfg
        self.top_k = top_k
        self.default_head = head
        self.batcher = MicroBatcher(buckets)
        self.mesh = mesh
        self.spmd = spmd
        self._w_aug_cache: torch.Tensor | None = None
        # epoch id -> _IndexEpoch; index_epoch names the SERVING one
        self._epochs: dict[int, _IndexEpoch] = {}
        self.index_epoch: int = 0     # 0 = no fitted index yet
        self._epoch_seq: int = 0
        self._full_head: Callable | None = None
        # steps: (head, bucket) score steps and (head, "decode[...]")
        # fused decode steps; the index-free full-head ones here, LSS ones
        # in their _IndexEpoch.  One build-count table spans all epochs.
        self._steps: dict[tuple[str, Any], Step] = {}
        self.compile_counts: dict[tuple[str, Any], int] = {}
        self._count_lock = threading.Lock()   # compile_counts only
        self.calib: tuple | None = None   # (q, labels) refs from last fit
        self._queue: list[_Pending] = []
        self._results: list[RankResult] = []
        self._next_rid = 0
        self.lock = threading.RLock()
        self.obs = obs.MetricsRegistry(scope_prefix="engine")
        self._h_lat = self.obs.histogram(
            "engine_request_latency_seconds",
            "submit -> result per ranked request")
        self.obs.collect(self._collect_gauges)
        if audit_rate is None:
            audit_rate = obs.audit_rate_from_env(0.0)
        self.auditor = None
        if audit_rate > 0:
            # offers are gated per request group on kind != "full"
            self.auditor = RecallAuditor(self, audit_rate)
        self.reset_metrics()

    @property
    def _w_aug(self) -> torch.Tensor:
        """Bias-augmented neurons, built on first LSS use."""
        if self._w_aug_cache is None:
            self._w_aug_cache = simhash.augment_neurons(self.w, self.b)
        return self._w_aug_cache

    # ------------------------------------------------- offline fitting --
    def fit(self, generator: torch.Generator, calib_batches: list, labels,
            verbose: bool = False) -> dict:
        """Paper Algorithm 1: embed the calibration batches through the
        frozen model body, then IUL-train the hyperplanes."""
        if self.embed_fn is None:
            raise ValueError("fit() needs an embed_fn; use "
                             "fit_from_queries() when requests are raw "
                             "embeddings")
        with torch.no_grad():
            q = torch.cat([self.embed_fn(bb) for bb in calib_batches])
        return self.fit_from_queries(generator, q, labels, verbose=verbose)

    def fit_from_queries(self, generator: torch.Generator, q: torch.Tensor,
                         labels: torch.Tensor, verbose: bool = False
                         ) -> dict:
        index, hist = fit_lss(generator, q, labels, self.w, self.b,
                              self.lss_cfg, verbose=verbose)
        self.calib = (q, labels)
        self._set_index(index)
        return hist

    def fit_random(self, generator: torch.Generator) -> None:
        """SimHash init without IUL (the SLIDE-style baseline)."""
        theta = simhash.init_hyperplanes(generator, self._w_aug.shape[1],
                                         self.lss_cfg.k_bits,
                                         self.lss_cfg.n_tables,
                                         device=self.device)
        self._set_index(build_index(self._w_aug, theta, self.lss_cfg))

    # --------------------------------------------------- index lifecycle --
    @property
    def index(self) -> LSSIndex | None:
        """The SERVING epoch's index (None before any fit)."""
        st = self._epochs.get(self.index_epoch)
        return None if st is None else st.index

    def index_for(self, epoch: int) -> LSSIndex:
        """The index a specific (e.g. pinned) epoch serves."""
        return self._epoch_state(epoch).index

    def _epoch_state(self, epoch: int | None = None) -> _IndexEpoch:
        e = self.index_epoch if epoch is None else epoch
        st = self._epochs.get(e)
        if st is None:
            if e == 0:
                raise ValueError("LSS head needs a fitted index: call "
                                 "fit()/fit_random()")
            raise KeyError(f"index epoch {e} is gone (unpinned epochs "
                           f"are dropped at swap)")
        return st

    def _set_index(self, index: LSSIndex) -> None:
        """Install ``index`` as the serving epoch immediately (the
        offline fit path).  Online refresh goes through
        :meth:`swap_index` instead — prepare + warm + guarded flip."""
        self._swap_prepared(self.prepare_epoch(index))

    def prepare_epoch(self, index: LSSIndex) -> int:
        """Register ``index`` as a new, not-yet-serving epoch.  Its heads
        and steps are built lazily or via :meth:`warm_epoch` — none of it
        on the serving path, none of it under a lock held across device
        work."""
        with self.lock:
            self._epoch_seq += 1
            e = self._epoch_seq
            self._epochs[e] = _IndexEpoch(e, index)
            return e

    def warm_epoch(self, epoch: int, shapes=None) -> None:
        """Build the prepared epoch's LSS score steps for the bucket
        shapes the serving epoch already built (or explicit ``shapes``,
        ``(kind, bucket)`` pairs), so post-swap traffic replays captured
        graphs instead of paying a capture on its first chunk.  Runs off
        the serving path: a build holds the step's own lock, not
        ``self.lock``.  Decode steps are not warmed here — a scheduler
        generation builds its fused step when it first dispatches under
        the new epoch.  No-op on multihost engines (a leader-side dry run
        would ship opcodes; the fleet warms in lockstep through its first
        post-swap chunks) and on ``embed_fn`` engines (request shapes are
        not fabricable here)."""
        if self.spmd is not None or self.embed_fn is not None:
            return
        if shapes is None:
            cur = self._epochs.get(self.index_epoch)
            shapes = [] if cur is None else \
                [k for k in list(cur.steps) if isinstance(k[1], int)]
        d = int(self.w.shape[1])
        for kind, bucket in shapes:
            step = self._step(kind, bucket, epoch=epoch)
            step(np.zeros((bucket, d), np.float32))

    def _swap_prepared(self, epoch: int) -> int:
        """Flip the serving epoch to ``epoch`` — the only mutation on the
        swap path, O(1) under the lock, so it lands between runtime
        chunks: a chunk that fetched its step before the flip runs the
        old generation to completion, every fetch after runs the new.
        Every other unpinned epoch is dropped, and its steps' graphs
        released outside the lock.  Lock order channel -> engine, as
        ``submit``/``flush``."""
        with self._channel_lock(), self.lock:
            st = self._epoch_state(epoch)       # raises if dropped
            faults.fire(faults.ENGINE_SWAP, epoch=epoch)
            old = self.index_epoch
            self.index_epoch = st.epoch
            dropped = [self._epochs.pop(k) for k, s in
                       list(self._epochs.items())
                       if k != st.epoch and s.pins <= 0]
        del dropped
        release_graphs()
        obs.event("index_swap", epoch=epoch, prev=old)
        return epoch

    def swap_index(self, index: LSSIndex, *, warm: bool = True) -> int:
        """Online refresh entry: register ``index`` as a new epoch, warm
        its score steps off the serving path, then flip.  On a multihost
        leader the flip rides an ``OP_SWAP_INDEX`` message so followers
        rebuild and flip in lockstep; followers swap only through that
        channel (``follower_loop``), never directly.  Returns the new
        epoch id."""
        if self.spmd is not None:
            if not self.spmd.is_leader:
                raise RuntimeError(
                    "followers swap via the OP_SWAP_INDEX message in "
                    "follower_loop, not swap_index()")
            from repro_torch.serve.multihost import leader_swap_index
            return leader_swap_index(self.spmd, self, index)
        e = self.prepare_epoch(index)
        if warm:
            self.warm_epoch(e)
        return self._swap_prepared(e)

    def swap_from_theta(self, theta: torch.Tensor) -> int:
        """Follower-side swap: rebuild the index from the leader's
        hyperplanes against this engine's own ``_w_aug`` and flip.
        ``build_index`` is value-deterministic, so the same θ gives a
        bit-identical index without shipping buckets."""
        theta = torch.as_tensor(theta, dtype=torch.float32,
                                device=self.device)
        index = build_index(self._w_aug, theta, self.lss_cfg)
        return self._swap_prepared(self.prepare_epoch(index))

    def pin_epoch(self, epoch: int | None = None) -> int:
        """Pin an epoch (default: the serving one) so a swap cannot drop
        it — decode sessions rank through the generation they prefilled
        under until they leave.  Returns the pinned epoch id."""
        with self.lock:
            st = self._epoch_state(epoch)
            st.pins += 1
            return st.epoch

    def unpin_epoch(self, epoch: int) -> None:
        """Release a pin; a non-serving epoch with no pins left is
        dropped (its index, heads and steps become collectable)."""
        with self.lock:
            st = self._epochs.get(epoch)
            if st is None:
                return
            st.pins -= 1
            if st.pins <= 0 and epoch != self.index_epoch:
                del self._epochs[epoch]
        del st
        # on the serving path (the scheduler's tick): never wait on a
        # capture; a running one releases the graphs when it ends
        release_graphs(block=False)

    def drop_step(self, kind: str, tag) -> None:
        """Remove one cached step (every epoch's copy included) — the
        scheduler-replacement path uses this so an outgrown fused step
        (and the pool tensors its graph holds) cannot collide with its
        successor's tag."""
        with self.lock:
            dropped = [self._steps.pop((kind, tag), None)]
            for st in self._epochs.values():
                dropped.append(st.steps.pop((kind, tag), None))
        del dropped
        release_graphs()

    # ------------------------------------------------------ head lookup --
    def _get_mesh(self):
        if self.spmd is not None:
            return self.spmd.mesh
        if self.mesh is None:
            self.mesh = make_serving_mesh()
        return self.mesh

    def _head(self, kind: str, st: _IndexEpoch | None = None) -> Callable:
        if kind not in HEAD_KINDS:
            raise ValueError(f"unknown head {kind!r}")
        if kind == "full":
            if self._full_head is None:
                self._full_head = make_full_head(self.w, self.b,
                                                 self.top_k)
            return self._full_head
        st = st if st is not None else self._epoch_state()
        if kind in st.heads:
            return st.heads[kind]
        if kind == "lss":
            w_aug = None if st.index.w_bucketed is not None \
                else self._w_aug
            head = make_lss_head(st.index, w_aug, self.top_k)
        else:
            mesh = self._get_mesh()
            if mesh.backend == "nccl" and mesh.device != self.device:
                raise ValueError(f"the engine's weights are on "
                                 f"{self.device}, its NCCL rank drives "
                                 f"{mesh.device}")
            stack, w_stack, m_local = self._shards(st, mesh)
            make = (make_multihost_lss_head if self.spmd is not None
                    else make_sharded_lss_head)
            head = make(stack, w_stack, mesh, m_local, self.top_k)
        st.heads[kind] = head
        return head

    def _shards(self, st: _IndexEpoch, mesh):
        """The epoch's vocab shards that this rank holds, built once from
        ONLY its ``row_range`` of W (the JAX package's single-process path
        shards the whole ``_w_aug``; the shards are the same bits)."""
        if st.sharded is None:
            m = self.w.shape[0]
            r0, r1 = mesh.row_range(m)
            w_aug_local = simhash.augment_neurons(self.w[r0:r1],
                                                  self.b[r0:r1])
            st.sharded = shard_index(w_aug_local, st.index.theta,
                                     self.lss_cfg, mesh.n_shards,
                                     shard_range=mesh.shard_range(),
                                     m_total=m)
        return st.sharded

    # ------------------------------------------------------------ steps --
    def _step(self, kind: str, bucket: int,
              epoch: int | None = None) -> Step:
        """One step per (head, bucket) per index epoch: a CUDA graph on
        the card, captured at its first call; eager on the CPU.  The
        build count is bumped once per build, as a JAX trace bumps it.
        ``epoch`` selects a pinned generation's table (the decode path);
        None serves the current epoch."""
        key = (kind, bucket)
        # lock-free hot path: a GIL-atomic dict read, so the runtime's
        # dispatcher never stalls behind a user thread's flush()
        table = (self._steps if kind == "full"
                 else self._epoch_state(epoch).steps)
        step = table.get(key)
        if step is not None:
            return step
        with self.lock:
            if key not in table:
                head = self._head(kind, None if kind == "full"
                                  else self._epoch_state(epoch))
                embed = self.embed_fn
                # a split head's graph ends at the shard-local winners;
                # its merge runs after the replay
                local = getattr(head, "local", head)

                def fn(x):
                    return local(embed(x) if embed is not None else x)

                post = getattr(head, "merge", None)
                step = Step(fn, self.device, self._counter(key), post=post)
                if self.spmd is not None and self.spmd.is_leader:
                    # the SPMD seam: sync rank/flush AND the runtime
                    # dispatcher all fetch from here, so wrapping the
                    # leader's step makes every admission path ship its
                    # batch to the follower_loop processes first
                    from repro_torch.serve.multihost import make_leader_step
                    step = make_leader_step(self.spmd, step, kind)
                table[key] = step
            return table[key]

    def _counter(self, key) -> Callable[[], None]:
        """The ``on_build`` hook of the step under ``key``: it runs under
        the step's lock, so it takes ``_count_lock`` (held around nothing
        else), never ``self.lock`` (held by ``flush`` around step calls)."""
        def on_build():
            with self._count_lock:
                self.compile_counts[key] = self.compile_counts.get(key, 0) + 1
        return on_build

    def n_builds(self) -> int:
        """Builds so far, over every (head, shape) and epoch."""
        with self._count_lock:
            return sum(self.compile_counts.values())

    def decode_logits(self, kind: str, tag: str, body: Callable,
                      epoch: int | None = None) -> Step:
        """The batched decode head entry: one fused step per (head kind,
        ``tag``) running ``body`` (the model's pooled or paged decode
        step) straight into this engine's head, so the WOL ranking inside
        the token loop is the same kernel path the score buckets use.

        ``body(params, tok, k, v, *ops) -> (hidden [B, d], k, v)`` writes
        the step's KV into the pool's ``k``/``v`` in place; ``ops`` are
        the layout's host operands — dense ``(lengths,)``, paged
        ``(page_table, lengths)``.  The returned :class:`Step` maps
        ``(params, tok, k, v, *ops)`` to ``(hidden, HeadOutput)``, with
        ``tok_next = max(ids[:, 0], 0)`` written into ``tok`` on the
        device, so a decode loop chains steps without a host round trip
        (the JAX step returns ``tok_next``, ``k`` and ``v``; here they are
        the caller's own tensors, updated in place).  ``tag`` names the step's shape (the
        scheduler uses "decode[SxW]@cfg", paged "decode[SxW,pagedP]@cfg")
        and keys the step table — builds land in
        ``compile_counts[(kind, tag)]`` next to the score buckets.  LSS
        decode steps live in their index epoch's table (``epoch`` pins a
        draining generation, None serves the current one).

        On the card the step is a CUDA graph over the pool's own slabs,
        updated in place: the port's counterpart of the JAX step's
        donation of the slabs on TPU.  For a split head (``lss-sharded``)
        the graph ends at the shard-local winners; the merge and the
        ``tok`` write run after the replay, on the current stream.
        """
        key = (kind, tag)
        table = (self._steps if kind == "full"
                 else self._epoch_state(epoch).steps)
        step = table.get(key)             # lock-free hot path, like _step
        if step is not None:
            return step
        with self.lock:
            if key not in table:
                head = self._head(kind, None if kind == "full"
                                  else self._epoch_state(epoch))
                merge = getattr(head, "merge", None)
                local = getattr(head, "local", head)

                def fn(params, tok, k, v, *ops):
                    hidden, _, _ = body(params, tok, k, v, *ops)
                    out = local(hidden.float())
                    if merge is None:
                        tok.copy_(out.ids[:, 0].clamp(min=0))
                    return hidden, out

                def post(params, tok, k, v, out):
                    hidden, part = out
                    ho = merge(part)
                    tok.copy_(ho.ids[:, 0].clamp(min=0))
                    return hidden, ho

                # (params, tok, k, v) bound; the warm-up's tokens undone
                table[key] = Step(fn, self.device, self._counter(key),
                                  n_bound=4, restore=(1,),
                                  post=None if merge is None else post)
            return table[key]

    # ------------------------------------------------------- score path --
    def rank(self, x, head: str | None = None, labels=None,
             record: bool = True, epoch: int | None = None) -> HeadOutput:
        """Rank one already-batched request group (rows = requests).

        Pads to the bucket, runs the (head, bucket) step, slices back to
        the true row count; returns tensors on the engine's device.
        ``labels`` (int [B, NL], -1 padded) feed the recall metric.  The
        decode loop calls this with ``record=False`` and with ``epoch``
        set to its pinned index generation, so prefill first tokens stay
        consistent with its fused decode steps across an index swap.
        """
        kind = head or self.default_head
        n = tree_leaves(x)[0].shape[0]
        t0 = time.perf_counter()
        outs = []
        for chunk in self.batcher.plan(n):
            part = tree_map(
                lambda leaf: leaf[chunk.start:chunk.start + chunk.size], x)
            o = self._step(kind, chunk.bucket, epoch)(
                _pad_to_bucket(part, chunk.bucket))
            outs.append(tree_map(lambda leaf: leaf[:chunk.size], o))
        out = outs[0] if len(outs) == 1 else HeadOutput(
            *(None if any(leaf is None for leaf in ls) else torch.cat(ls)
              for ls in zip(*outs)))
        if record:
            host = HostOutput(out).wait()
            wall = time.perf_counter() - t0
            self._record(host, n, wall, [wall] * n, labels)
            if self.auditor is not None and kind != "full":
                self.auditor.offer(x, host.ids)
        return out

    # --------------------------------------------------- request queue --
    def _channel_lock(self):
        """The multihost opcode-channel lock when this process is the
        leader (a no-op context otherwise).  Entry points that hold
        ``self.lock`` across a leader-wrapped step (submit/flush) take it
        FIRST, so lock order is always channel -> engine — the same order
        ``multihost.leader_generate`` (channel) -> decode-step build
        (engine) uses.  Both locks are reentrant."""
        if self.spmd is not None and self.spmd.is_leader:
            return self.spmd.lock
        return contextlib.nullcontext()

    def submit(self, x, labels=None) -> int:
        """Enqueue one example (leaves WITHOUT the batch dim).  Returns a
        request id; auto-flushes once a full max bucket is waiting."""
        x = tree_map(host_numpy, x)
        with self._channel_lock(), self.lock:
            rid = self._next_rid
            self._next_rid += 1
            self._queue.append(_Pending(rid, x, _as_label_row(labels),
                                        time.perf_counter()))
            if len(self._queue) >= self.batcher.max_bucket:
                self._flush_ready()
            return rid

    def submit_batch(self, xb, labels=None) -> list[int]:
        """Enqueue every row of a batched pytree."""
        xb_np = tree_map(host_numpy, xb)         # one device->host copy
        n = tree_leaves(xb_np)[0].shape[0]
        lab = None if labels is None else host_numpy(labels)
        with self._channel_lock(), self.lock:    # rids stay contiguous
            return [self.submit(tree_map(lambda leaf: leaf[i], xb_np),
                                None if lab is None else lab[i])
                    for i in range(n)]

    def _flush_ready(self) -> None:
        while len(self._queue) >= self.batcher.max_bucket:
            group = self._queue[:self.batcher.max_bucket]
            del self._queue[:self.batcher.max_bucket]
            self._results.extend(self._run_group(group))

    def flush(self, head: str | None = None) -> list[RankResult]:
        """Drain the queue through bucketed steps; return all finished
        results (including auto-flushed ones) in submit order."""
        with self._channel_lock(), self.lock:
            while self._queue:
                take = min(len(self._queue), self.batcher.max_bucket)
                group = self._queue[:take]
                del self._queue[:take]
                self._results.extend(self._run_group(group, head))
            out = sorted(self._results, key=lambda r: r.rid)
            self._results = []
            return out

    def _run_group(self, group: list[_Pending],
                   head: str | None = None) -> list[RankResult]:
        kind = head or self.default_head
        bucket = self.batcher.bucket_for(len(group))
        x = stack_rows([g.x for g in group])
        padded = MicroBatcher.pad_rows(x, bucket)
        t0 = time.perf_counter()
        # waits on this group's own copy event, not the whole stream
        out = HostOutput(self._step(kind, bucket)(padded)).wait()
        t1 = time.perf_counter()
        n = len(group)
        lats = [t1 - g.t_submit for g in group]
        labels = self._stack_labels([g.labels for g in group])
        self._record(out, n, t1 - t0, lats, labels)
        if self.auditor is not None and kind != "full":
            self.auditor.offer(x, out.ids[:n])
        return [RankResult(g.rid, out.logits[i], out.ids[i])
                for i, g in enumerate(group)]

    @staticmethod
    def _stack_labels(rows) -> np.ndarray | None:
        if all(r is None for r in rows):
            return None
        width = max(1 if r is None else r.shape[0] for r in rows)
        out = np.full((len(rows), width), -1, np.int32)
        for i, r in enumerate(rows):
            if r is not None:
                out[i, :r.shape[0]] = r
        return out

    # ----------------------------------------------------------- metrics --
    def reset_metrics(self) -> None:
        """Start a fresh metrics window.  Pending request results are NOT
        metrics and survive (they belong to the next ``flush``)."""
        with self.lock:
            self._n = 0
            self._wall = 0.0
            self._h_lat.reset()
            self._sample_sum = 0
            self._recall_hit = 0
            self._recall_tot = 0

    def _record(self, out: HeadOutput, n: int, wall: float,
                lats: list[float], labels) -> None:
        """Fold one group into the window; ``out`` holds numpy arrays of
        at least ``n`` rows (``HostOutput.wait``)."""
        sample = int(np.sum(out.sample_size[:n], dtype=np.int64))
        hit = tot = 0
        if labels is not None:
            lab = np.asarray(host_numpy(labels))[:n]
            if lab.ndim == 1:                 # one label per request
                lab = lab[:, None]
            pool = out.cand_ids if out.cand_ids is not None else out.ids
            found = (lab[:, :, None] == pool[:n, None, :]).any(-1)
            valid = lab >= 0
            hit, tot = int(np.sum(found & valid)), int(np.sum(valid))
        with self.lock:
            self._n += n
            self._wall += wall
            for v in lats:
                self._h_lat.record(v)
            self._sample_sum += sample
            self._recall_hit += hit
            self._recall_tot += tot

    def _collect_gauges(self, reg) -> None:
        """Exporter hook: surface the ServeMetrics window as gauges at
        snapshot time (no double bookkeeping on the record path)."""
        m = self.metrics()
        reg.gauge("engine_requests_total").set(m.n_requests)
        reg.gauge("engine_throughput_rps").set(m.throughput_rps)
        reg.gauge("engine_avg_sample_size").set(m.avg_sample_size)
        reg.gauge("engine_label_recall").set(m.label_recall)
        reg.gauge("engine_compiles_total").set(m.n_compiles)

    def metrics(self) -> ServeMetrics:
        # quantiles come off the histogram's own bounded reservoir, not
        # under self.lock — a metrics() poll never stalls flush()
        p50, p95, p99 = self._h_lat.quantile((50, 95, 99))
        with self.lock:
            return ServeMetrics(
                n_requests=self._n,
                wall_s=self._wall,
                avg_sample_size=self._sample_sum / max(self._n, 1),
                throughput_rps=self._n / self._wall if self._wall else 0.0,
                latency_p50_ms=float(p50 * 1e3),
                latency_p95_ms=float(p95 * 1e3),
                latency_p99_ms=float(p99 * 1e3),
                label_recall=(self._recall_hit / self._recall_tot
                              if self._recall_tot else math.nan),
                n_compiles=self.n_builds(),
            )


# ================================================= compatibility wrapper ==

class WOLServer:
    """Legacy facade: one wide output layer, full or LSS head; all work
    happens in the unified :class:`Engine`."""

    def __init__(self, embed_fn: Callable, w: torch.Tensor,
                 b: torch.Tensor | None, cfg: LSSConfig, top_k: int = 5):
        self.engine = Engine(embed_fn, w, b, cfg, top_k=top_k)

    @property
    def index(self):
        return self.engine.index

    def fit(self, generator: torch.Generator, calib_batches: list[dict],
            labels: torch.Tensor, verbose: bool = False) -> dict:
        return self.engine.fit(generator, calib_batches, labels,
                               verbose=verbose)

    def serve(self, batches: list[dict], use_lss: bool = True
              ) -> tuple[list, ServeMetrics]:
        if use_lss and self.engine.index is None:
            raise ValueError("fit() first")
        self.engine.reset_metrics()
        kind = "lss" if use_lss else "full"
        out = []
        for b in batches:
            ho = self.engine.rank(b, head=kind)
            out.append((ho.logits, ho.ids))
        return out, self.engine.metrics()


class LMDecoder:
    """Session-based LM decode; the per-token head is the Engine's.

    A thin facade over a :class:`repro_torch.serve.decode.DecodeScheduler`:
    ``generate`` submits one session per prompt row into a fixed-slot
    scheduler and blocks for the streams, so the blocking API and the
    AsyncRuntime's streaming path run the SAME fused ``decode_step_pooled
    | decode_step_paged -> head`` step — one build per (head, pool shape)
    across all ``generate`` calls and all sessions, and blocking results
    are bit-identical to interleaved ones.

    ``max_streams`` fixes the slot count (the fused step's row shape);
    ``max_len`` fixes the pool cache width.  Both are graph shapes AND
    numeric shapes (reductions differ across shapes at the ulp level),
    so pin them when comparing runs.  ``max_len=None`` sizes the pool
    lazily from the first ``generate`` call (growing it later rebuilds).
    The engine runs on the parameters' device; the JAX package's
    ``impl``, ``dedup`` and ``slab_dtype`` arguments are the device's
    choice and ``lss_cfg``'s here.  ``spmd`` runs the engine on a
    multihost fleet (see :class:`Engine`; decode on a fleet is blocking
    ``generate`` mirrored on every process, ``multihost.leader_generate``).
    """

    def __init__(self, params: dict, cfg, lss_cfg: LSSConfig | None = None,
                 *, max_streams: int = 8, max_len: int | None = None,
                 kv_layout: str | None = None,
                 kv_page_tokens: int | None = None,
                 kv_pages: int | None = None, spmd=None):
        from repro_torch.models import transformer as T
        self.T = T
        self.params = params
        self.cfg = cfg
        self.lss_cfg = lss_cfg
        self.max_streams = max_streams
        self._max_len = max_len
        # KV storage layout knobs, handed to each scheduler's pool:
        # layout dense|paged (None -> kv_pool.layout strategy /
        # $REPRO_KV_LAYOUT), page size, and an optional arena page cap
        self.kv_layout = kv_layout
        self.kv_page_tokens = kv_page_tokens
        self.kv_pages = kv_pages
        self._scheds: dict[str, Any] = {}
        self.engine = Engine(None, self.head_weights().float(), None,
                             lss_cfg or LSSConfig(), top_k=1, head="full",
                             spmd=spmd)

    @property
    def index(self):
        return self.engine.index

    @property
    def device(self) -> torch.device:
        return self.engine.device

    def head_weights(self) -> torch.Tensor:
        return (self.params["embed"] if self.cfg.tie_embeddings
                else self.params["lm_head"])

    def fit_lss(self, generator: torch.Generator, calib_tokens,
                verbose: bool = False) -> dict:
        """Calibrate the LSS index from the hidden states of the prompt
        pass; labels are the observed next tokens (teacher forcing —
        exactly the paper's 'training data through the trained model'
        recipe)."""
        toks = torch.as_tensor(np.asarray(host_numpy(calib_tokens)),
                               device=self.device)
        with torch.no_grad():
            hidden, _, _ = self.T.forward(self.params, toks, self.cfg,
                                          mode="train")
        q = hidden[:, :-1].reshape(-1, hidden.shape[-1]).float()
        labels = toks[:, 1:].reshape(-1, 1).int()
        return self.engine.fit_from_queries(generator, q, labels,
                                            verbose=verbose)

    def scheduler(self, head: str | None = None, min_len: int | None = None):
        """The per-head-kind DecodeScheduler (built lazily, reused across
        ``generate`` calls and by the AsyncRuntime's decode path).

        A ``min_len`` beyond the current pool width rebuilds the
        scheduler ONLY when the old one is idle and unattached; a
        scheduler an AsyncRuntime owns (or one with sessions in flight)
        must not be swapped out from under it — that raises instead, so
        callers size ``max_len`` up front.
        """
        from repro_torch.serve.decode import DecodeScheduler
        kind = head or self.engine.default_head
        if kind != "full" and self.engine.index is None:
            raise ValueError("fit_lss() first")
        need = max(min_len or 0, self._max_len or 0)
        sched = self._scheds.get(kind)
        if sched is not None and sched.max_len >= need:
            return sched
        if sched is not None:
            if sched.on_session_done is not None or not sched.idle:
                raise ValueError(
                    f"head {kind!r} scheduler has pool width "
                    f"{sched.max_len} < required {need} but is busy or "
                    f"runtime-attached; construct the LMDecoder with "
                    f"max_len >= {need} instead of growing it mid-flight")
            # outgrown and safely replaceable: drop its fused step (and
            # the pool tensors its graph holds) from the engine's table
            self.engine.drop_step(kind, sched._tag)
        self._max_len = (max(need, 64) if self._max_len is None
                         else max(self._max_len, need))
        sched = DecodeScheduler(self.engine, self.params, self.cfg,
                                max_streams=self.max_streams,
                                max_len=self._max_len, head=kind,
                                kv_layout=self.kv_layout,
                                kv_page_tokens=self.kv_page_tokens,
                                kv_pages=self.kv_pages)
        self._scheds[kind] = sched
        return sched

    def generate(self, prompt, steps: int, head: str | None = None,
                 timeout: float | None = None) -> torch.Tensor:
        """Greedy decode.  prompt [B, S] -> int32 tokens [B, steps] (on
        the CPU).

        ``head`` is ``full``, ``lss`` or ``lss-sharded`` (None: the
        engine's default, ``full``).  Rows run as sessions through the
        slot pool: ``B > max_streams`` decodes in waves of
        ``max_streams``.  Safe while an AsyncRuntime serves the same
        scheduler — ticks serialize, and this call returns once ITS
        streams finish, leaving other producers' sessions in flight."""
        kind = head or self.engine.default_head
        rows = np.asarray(host_numpy(prompt), np.int32)
        sched = self.scheduler(head=kind, min_len=rows.shape[1] + steps)
        streams = [sched.submit(rows[i], max_new_tokens=steps)
                   for i in range(rows.shape[0])]
        sched.run(timeout=timeout,
                  until=lambda: all(s.done() for s in streams))
        return torch.from_numpy(np.stack([s.result() for s in streams]))
