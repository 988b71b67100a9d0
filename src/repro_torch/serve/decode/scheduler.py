"""Continuous-batching decode scheduler (counterpart of
``repro.serve.decode.scheduler``).

Sessions JOIN a slot in a fixed-shape KV pool after prefill and LEAVE on
EOS or token budget, and every step runs ONE fused step over all
``max_streams`` slots::

    decode_step_pooled | decode_step_paged (per-row cache lengths)
        -> Engine head (full | lss: the lss_topk kernel on the card)
        -> next-token feedback  (tokens stay ON DEVICE)

Because the step shape never changes, the step is built once per (head,
pool) no matter how sessions come and go — the Engine keeps it in the
same step table as the score-path buckets (``Engine.decode_logits``),
so build counts stay observable.  On the card the step is a CUDA graph
over the pool's own slabs, replayed once a step.

Overlap: the scheduler is software-pipelined one step deep.  ``tick()``
dispatches step k (a graph replay; the next tokens feed the next step
device-to-device, and the step's ids leave through a clone and pinned
copies with an event of their own) and THEN waits for step k-1's ids,
resolves the per-token streams, and retires finished sessions.  The
host-side work for step k+1 (joins, length bumps, stream resolution)
thus runs while the device executes step k.  The one-step lag means a
session discovered finished at step k-1 still occupied its row during
step k — that wasted row is discarded, never emitted, and
row-parallelism keeps it from perturbing live rows.

Everything a tick puts on the device — a join's prefill and scatter, a
joining slot's first token, the step's replay — goes on the device's
current stream, so the stream runs them in the order they were issued.

Token-exactness: row i of the fused step computes exactly what a
single-stream run computes at the same pool shape, so interleaved decode
is bit-identical to sequential ``LMDecoder.generate`` calls on the same
decoder (full AND lss heads).  For an MoE model this needs a dropless
configuration (``capacity_factor`` None), or rows few enough that no
expert overflows its capacity.

Routing counts (MoE models only): the fused step also writes each
layer's tokens per expert (``[n_layers, Ep]`` int32) into a static
output of its graph, which comes home in the step's own
``output.copy``; a ``tick`` span carries the counts of the step it
collected, a ``prefill`` span those of its forward, as ``experts_hit``
(experts with a token, summed over the layers), ``expert_max`` (the most
tokens at one expert in any layer) and ``moe_layers``.  A dense model's
step, its outputs and its copy have none of this.
"""

from __future__ import annotations

import functools
import math
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import HostOutput
from repro_torch.obs.tracing import NOOP_SPAN
from repro_torch.serve.decode.kv_pool import KVCachePool, KVPoolExhaustedError
from repro_torch.serve.decode.sessions import DecodeSession, TokenStream
from repro_torch.serve.runtime.future import DeadlineExceededError

__all__ = ["DecodeScheduler", "DecodeStats"]


# prefill build counter, keyed (cfg.name, bucket) — the observable that
# proves bucketing works: O(log max_len) entries per cfg, not O(distinct
# prompt lengths).  Module-level as the JAX package's jit cache is (one
# entry serves every scheduler of a cfg); the lock serialises other
# schedulers' tick threads and the stats() read.  Prefill runs eagerly:
# an entry counts the first prefill at its (cfg, bucket), as a JAX trace.
_PREFILL_COMPILES: dict[tuple, int] = {}
_PREFILL_LOCK = threading.Lock()

_MIN_PREFILL_BUCKET = 8


def _no_span(name: str):
    """An idle tick's spans: the shared no-op."""
    return NOOP_SPAN


def _routing_attrs(counts: np.ndarray | None) -> dict:
    """A span's routing attributes from one pass's tokens per expert
    ``[n_layers, Ep]`` (none for a dense model)."""
    if counts is None:
        return {}
    return {"experts_hit": int((counts > 0).sum()),
            "expert_max": int(counts.max()), "moe_layers": counts.shape[0]}


def _prefill_bucket(plen: int) -> int:
    """Power-of-two prefill bucket for a prompt length (floor 8).

    The bucket is BOTH the build shape and a numeric shape: prefill's
    attention reduces over the padded width, and reductions are not
    shape-invariant at the ulp level — so prompt KV is only
    bit-reproducible within one bucket, and every prefix-cache key
    includes it.  Causal masking makes end-padding exact: position i
    attends only to j <= i, so the pad tail cannot perturb real rows.
    """
    return max(_MIN_PREFILL_BUCKET, 1 << max(plen - 1, 0).bit_length())


def _prefill(params, prompt: torch.Tensor, cfg, max_len: int,
             expert_counts: torch.Tensor | None = None):
    """Prefill at a bucket width, counted per (cfg, bucket)."""
    from repro_torch.models import transformer as T
    key = (cfg.name, max_len)
    with _PREFILL_LOCK:
        if key not in _PREFILL_COMPILES:
            _PREFILL_COMPILES[key] = 1
    return T.prefill(params, prompt, cfg, max_len=max_len,
                     expert_counts=expert_counts)


class DecodeStats(NamedTuple):
    """Point-in-time snapshot of the scheduler's serving behaviour."""

    n_sessions: int              # sessions handed to the scheduler
    n_finished: int              # completed (eos | max_tokens)
    n_shed_deadline: int         # shed while waiting for a slot
    n_tokens: int                # tokens emitted across all streams
    n_steps: int                 # fused decode steps dispatched
    slot_occupancy: float        # mean active/max_streams per step
    ttft_p50_ms: float           # submit -> first token (queue incl.)
    ttft_p95_ms: float
    ttft_p99_ms: float
    itl_p50_ms: float            # inter-token gap
    itl_p95_ms: float
    itl_p99_ms: float
    tokens_per_s: float          # n_tokens / (first submit -> last token)
    wall_s: float
    n_prefill_skipped: int = 0   # full-prompt prefix hits (no prefill run)
    n_prefill_compiles: int = 0  # prefill builds for this cfg (all buckets)
    n_prefill_buckets: int = 0   # distinct prefill buckets built
    prefix_hit_rate: float = math.nan   # shared / shareable prompt pages
    kv_pages_in_use: int = 0     # paged layout: pages referenced now
    kv_peak_pages: int = 0       # paged layout: high-water mark
    n_shed_kv_oom: int = 0       # sessions shed: paged arena exhausted


class _Inflight(NamedTuple):
    host: HostOutput             # the step's ids on their way to the host
    out: tuple                   # (hidden, HeadOutput, *routing), cloned
    snapshot: list               # [(slot, session)] active at dispatch


class DecodeScheduler:
    """Session-based streaming decode over one Engine head.

    Args:
      engine: the serving Engine; supplies the head and keeps the fused
        step and its build count.
      params, cfg: the LM whose ``decode_step_pooled`` feeds the head.
      max_streams: pool slots == rows of the fused step (a graph shape).
      max_len: pool cache width; every session needs
        ``len(prompt) + max_new_tokens <= max_len``.
      head: head kind for ALL sessions of this scheduler (one fused step
        serves one head; build one scheduler per head kind).
      kv_layout, kv_page_tokens, kv_pages: KV storage knobs, forwarded to
        :class:`KVCachePool` (layout None resolves the ``kv_pool.layout``
        strategy / ``$REPRO_KV_LAYOUT``; the paged layout enables prefix
        caching and prefill skipping).

    Threading: ``submit``/``add_session`` may be called from any thread;
    ticks serialise on an internal lock, so the AsyncRuntime's
    dispatcher and a blocking ``generate()`` may both drive one
    scheduler.
    """

    def __init__(self, engine, params: dict, cfg, *, max_streams: int = 8,
                 max_len: int = 256, head: str | None = None,
                 kv_layout: str | None = None,
                 kv_page_tokens: int | None = None,
                 kv_pages: int | None = None):
        self.engine = engine
        self.params = params
        self.cfg = cfg
        self.head = head or engine.default_head
        self.pool = KVCachePool(cfg, max_streams, max_len,
                                layout=kv_layout,
                                page_tokens=kv_page_tokens,
                                n_pages=kv_pages, device=engine.device)
        self.max_streams = int(max_streams)
        self.max_len = int(max_len)
        # the step's token column: a static input of its graph, which
        # each step overwrites with the next tokens on the device
        self.tok = torch.zeros((max_streams,), dtype=torch.int32,
                               device=engine.device)
        self.sessions: list[DecodeSession | None] = [None] * max_streams
        self._pending: deque[DecodeSession] = deque()
        self._inflight: _Inflight | None = None
        # names the fused step's shape in the engine's step table,
        # qualified by the model name so two schedulers over the SAME
        # engine with different model configs cannot collide.  The paged
        # layout is a different step (its arenas and page table), so it
        # gets a distinct tag.
        if self.pool.layout == "paged":
            self._tag = (f"decode[{max_streams}x{max_len},"
                         f"paged{self.pool.page_tokens}]@{cfg.name}")
        else:
            self._tag = f"decode[{max_streams}x{max_len}]@{cfg.name}"
        # first-token memo for full-prompt prefix hits: (prompt bytes,
        # bucket) -> (head index object at compute time, tok0).  Keyed on
        # the index IDENTITY so an LSS refit invalidates; bounded LRU.
        self._tok0_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._tok0_cache_cap = 1024
        # index-epoch pin for the CURRENT generation: one fused step
        # serves every active slot, so the whole generation (first admit
        # until the pool drains) ranks through one engine epoch.  Mutated
        # only under _tick_lock.
        self._epoch: int | None = None
        self._lock = threading.Lock()
        self._tick_lock = threading.Lock()
        self._next_sid = 0
        # hook for the AsyncRuntime: called (session, reason) whenever a
        # session reaches a terminal state, from the tick thread
        self.on_session_done: Callable | None = None
        # stats (guarded by _lock)
        self._n_sessions = 0
        self._n_finished = 0
        self._n_shed_deadline = 0
        self._n_shed_kv_oom = 0
        self._n_tokens = 0
        self._n_steps = 0
        self._n_prefill_skipped = 0
        self._occupancy_sum = 0.0
        self.obs = obs.MetricsRegistry(scope_prefix="decode")
        self._h_ttft = self.obs.histogram(
            "decode_ttft_seconds", "submit -> first token, queue included")
        self._h_itl = self.obs.histogram(
            "decode_itl_seconds", "inter-token gap")
        self._t_first: float | None = None
        self._t_last: float | None = None

    # --------------------------------------------------------------- admit --
    def make_session(self, prompt, max_new_tokens: int, *,
                     eos_id: int | None = None,
                     t_submit: float | None = None,
                     deadline: float | None = None) -> DecodeSession:
        """Build (and validate) a session WITHOUT enqueueing it — the
        AsyncRuntime admits through its AdmissionQueue first.  Sessions
        only enter this scheduler's stats on ``add_session``."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got {prompt.shape}")
        if prompt.shape[0] + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.shape[0]}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the pool width {self.max_len}")
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
        return DecodeSession(sid, prompt, max_new_tokens, eos_id=eos_id,
                             t_submit=t_submit, deadline=deadline)

    def add_session(self, session: DecodeSession) -> None:
        with self._lock:
            self._n_sessions += 1
            if self._t_first is None:
                self._t_first = session.stream.t_submit
            self._pending.append(session)

    def submit(self, prompt, max_new_tokens: int, *,
               eos_id: int | None = None,
               deadline: float | None = None) -> TokenStream:
        """Standalone entry point: validate, enqueue, return the stream.
        (Through the AsyncRuntime use ``runtime.submit_decode`` instead —
        it applies queue-depth admission control.)"""
        s = self.make_session(prompt, max_new_tokens, eos_id=eos_id,
                              deadline=deadline)
        self.add_session(s)
        return s.stream

    # ---------------------------------------------------------------- state --
    @property
    def idle(self) -> bool:
        with self._lock:
            pending = bool(self._pending)
        return (not pending and self._inflight is None
                and self.pool.n_active == 0)

    # ----------------------------------------------------------------- tick --
    def tick(self) -> bool:
        """One scheduler iteration: admit waiting sessions to free slots,
        dispatch the next fused step, then resolve the PREVIOUS step's
        tokens (the overlap).  Returns True while there is work."""
        with self._tick_lock:
            # only busy ticks get spans: the runtime dispatcher polls
            # tick() continuously, and idle polls are not work
            busy = (self._inflight is not None or self.pool.n_active > 0
                    or bool(self._pending))
            span = obs.span if busy else _no_span
            with span("tick") as tick_span:
                with span("tick.admit"):
                    self._admit()
                with span("tick.dispatch"):
                    inflight = self._dispatch()
                prev, self._inflight = self._inflight, inflight
                routing = None
                if prev is not None:
                    with span("tick.collect"):
                        routing = self._collect(prev)
                if self._epoch is not None and self.idle:
                    # generation drained: release the pinned index epoch
                    e, self._epoch = self._epoch, None
                    self.engine.unpin_epoch(e)
                tick_span.set(dispatched=self._inflight is not None,
                              collected=prev is not None,
                              active=self.pool.n_active,
                              slots=self.max_streams,
                              **_routing_attrs(routing))
            return prev is not None or self._inflight is not None \
                or not self.idle

    def run(self, timeout: float | None = None,
            until: Callable[[], bool] | None = None) -> None:
        """Drive ``tick`` until every session has resolved — or, with
        ``until``, until that predicate holds (so a caller waiting on its
        OWN streams stops ticking once they finish)."""
        t_end = None if timeout is None else time.perf_counter() + timeout
        while not self.idle and not (until is not None and until()):
            self.tick()
            if t_end is not None and time.perf_counter() > t_end:
                raise TimeoutError(
                    f"scheduler not drained within {timeout}s "
                    f"({self.pool.n_active} active, "
                    f"{len(self._pending)} pending)")
        if until is not None and self.pool.n_active == 0:
            # an early exit leaves the final (wasted) step in flight; if
            # no other producer is active, one more tick drains it
            self.tick()

    # ---------------------------------------------------------------- admit --
    def _admit(self) -> None:
        while self.pool.n_free:
            with self._lock:
                if not self._pending:
                    return
                sess = self._pending.popleft()
            now = time.perf_counter()
            if (sess.stream.deadline is not None
                    and now > sess.stream.deadline):
                # never executed: the slot-join analogue of the rank
                # path's shed-at-dispatch
                sess.finished = True
                sess.stream.fail(DeadlineExceededError(
                    f"decode session {sess.sid} exceeded its deadline by "
                    f"{(now - sess.stream.deadline) * 1e3:.1f} ms waiting "
                    f"for a slot"))
                self._done(sess, "shed_deadline")
                continue
            sess.stream.admitted()
            if self._epoch is None and self.head != "full":
                # first admit of a generation pins the serving epoch;
                # later joins inherit it
                self._epoch = self.engine.pin_epoch()
            slot = self.pool.alloc()
            try:
                plen = int(sess.prompt.shape[0])
                # bucket: the width the forward runs at (padded), which
                # prefill_attn_roofline's bound reads
                with obs.span("prefill", sid=sess.sid, slot=slot, plen=plen,
                              bucket=_prefill_bucket(plen)) as pspan:
                    tok0, routing = self._prefill(slot, sess.prompt)
                    pspan.set(**_routing_attrs(routing))
            except KVPoolExhaustedError as exc:
                # the join could not get pages (it unwound cleanly):
                # shed this one session, keep admitting/ticking the rest
                # (the prefill span ended shed_kv_oom)
                obs.event("shed_kv_oom", sid=sess.sid, at="join")
                self.pool.free(slot)
                sess.finished = True
                sess.stream.fail(exc)
                self._done(sess, "shed_kv_oom")
                continue
            if sess.stream.span is not None:
                sess.stream.span.event("join", slot=slot)
            self.tok[slot] = tok0         # on the stream, after the replay
            sess.slot = slot
            self.sessions[slot] = sess
            self._emit(sess, tok0, time.perf_counter())

    def _prefill(self, slot: int, prompt_np: np.ndarray
                 ) -> tuple[int, np.ndarray | None]:
        """Fill ``slot``'s KV for a prompt and return its first token and
        the forward's routing counts (None for a dense model or where no
        forward ran).

        Fast path: with the paged layout, a prompt whose every page is
        already in the pool's prefix cache joins straight from cached
        pages AND reuses the memoized first token — no prefill, no head
        ranking (``n_prefill_skipped``).  The memo is keyed on the
        prompt+bucket and on the engine's index object identity, so an
        LSS refit invalidates it.

        Slow path: pad the prompt to its power-of-two bucket (one build
        per bucket, not per length; causal masking keeps real rows
        exact), join the KV sliced to the pool width, and rank the last
        REAL row's hidden state through the bucket-1 score step of the
        pinned epoch, as the blocking loop does.
        """
        plen = int(prompt_np.shape[0])
        bucket = _prefill_bucket(plen)
        key = (prompt_np.tobytes(), bucket)
        idx = (self.engine.index if self._epoch is None
               else self.engine.index_for(self._epoch))
        memo = self._tok0_cache.get(key)
        if memo is not None and memo[0] is idx \
                and self.pool.join_from_cache(slot, prompt_np, plen,
                                              bucket):
            self._tok0_cache.move_to_end(key)
            with self._lock:
                self._n_prefill_skipped += 1
            obs.event("prefill_skip", plen=plen, bucket=bucket)
            return memo[1], None
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :plen] = prompt_np
        from repro_torch.models import transformer as T
        counts = T.new_expert_counts(self.cfg, self.engine.device)
        with obs.span("prefill.forward"), torch.no_grad():
            hidden, cache = _prefill(
                self.params, torch.from_numpy(padded).to(self.engine.device),
                self.cfg, bucket, counts)
        with obs.span("prefill.join"):
            k_new, v_new = cache.k, cache.v
            if bucket > self.max_len:             # pool never reads past
                k_new = k_new[:, :, :self.max_len]    # its own width
                v_new = v_new[:, :, :self.max_len]
            self.pool.join(slot, k_new, v_new, plen, prompt=prompt_np,
                           bucket=bucket)
        # waits for the forward and the join on the card too
        with obs.span("prefill.head"):
            ho = self.engine.rank(hidden[:, plen - 1].float(),
                                  head=self.head, record=False,
                                  epoch=self._epoch)
            tok0 = max(int(ho.ids[0, 0]), 0)
        self._tok0_cache[key] = (idx, tok0)
        if len(self._tok0_cache) > self._tok0_cache_cap:
            self._tok0_cache.popitem(last=False)
        # the head's rank waited for the forward: a copy of [L, Ep] home
        return tok0, None if counts is None else counts.cpu().numpy()

    # ------------------------------------------------------------- dispatch --
    @functools.cached_property
    def _body(self):
        """The model half of the fused step, layout-resolved.  Closes over
        ONLY ``cfg`` (plus the pool's width for the paged step), not
        ``self``.  An MoE model's body returns its routing counts after
        ``v``."""
        cfg = self.cfg
        if self.pool.layout == "paged":
            max_len = self.max_len

            def body(params, tok, k, v, page_table, lengths):
                from repro_torch.models import transformer as T
                counts = T.new_expert_counts(cfg, tok.device)
                out = T.decode_step_paged(params, tok, k, v, page_table,
                                          lengths, cfg, max_len, counts)
                return out if counts is None else (*out, counts)
        else:
            def body(params, tok, k, v, lengths):
                from repro_torch.models import transformer as T
                counts = T.new_expert_counts(cfg, tok.device)
                out = T.decode_step_pooled(params, tok, k, v, lengths, cfg,
                                           counts)
                return out if counts is None else (*out, counts)

        return body

    def decode_step(self):
        """This scheduler's fused step in the engine's table (built at
        its first dispatch)."""
        return self.engine.decode_logits(self.head, self._tag, self._body,
                                         epoch=self._epoch)

    def _dispatch(self) -> _Inflight | None:
        active = [i for i, s in enumerate(self.sessions) if s is not None]
        if not active:
            return None
        step = self.decode_step()
        # writes the next tokens into self.tok and the KV into the pool
        out = step(self.params, self.tok, *self.pool.step_operands())
        # the ids, and whatever the step returns after its HeadOutput (an
        # MoE step's routing counts), leave through pinned copies and an
        # event made now, before the next replay can run
        host = HostOutput((out[1].ids, *out[2:]))
        # snapshot BEFORE any oom shed below nulls a slot: collect skips
        # finished sessions by flag, not by table lookup
        snapshot = [(i, self.sessions[i]) for i in active]
        for s in self.pool.advance(active):
            # this row crossed a page boundary and the arena had nothing
            # left: shed THIS session and keep the rest of the batch
            # alive.  Its in-flight step's write landed in its mapped
            # page; freed now, its later rows write to scratch.
            self._shed_oom(self.sessions[s])
        with self._lock:
            self._n_steps += 1
            self._occupancy_sum += len(active) / self.max_streams
        return _Inflight(host, out, snapshot)

    # -------------------------------------------------------------- collect --
    def _collect(self, item: _Inflight) -> np.ndarray | None:
        """Emit a step's tokens; returns its routing counts (MoE)."""
        ids, *routing = item.host.wait()        # this step's event only
        t1 = time.perf_counter()
        for slot, sess in item.snapshot:
            if sess.finished:                    # retired after dispatch:
                continue                         # a wasted row, not a token
            self._emit(sess, max(int(ids[slot, 0]), 0), t1)
        return routing[0] if routing else None

    def _emit(self, sess: DecodeSession, tok: int, t: float) -> None:
        sess.stream.append(tok, t)
        sess.n_emitted += 1
        with self._lock:
            self._n_tokens += 1
            self._t_last = t
        if sess.eos_id is not None and tok == sess.eos_id:
            self._finish(sess, "eos")
        elif sess.n_emitted >= sess.max_new_tokens:
            self._finish(sess, "max_tokens")

    def _finish(self, sess: DecodeSession, reason: str) -> None:
        sess.finished = True
        sess.stream.finish(reason)
        if sess.slot is not None:
            self.sessions[sess.slot] = None
            self.pool.free(sess.slot)
        ttft = sess.stream.ttft_s()
        if ttft is not None:
            self._h_ttft.record(ttft)
        for gap in sess.stream.inter_token_s():
            self._h_itl.record(gap)
        self._done(sess, reason)

    def _shed_oom(self, sess: DecodeSession | None) -> None:
        """Retire ONE session whose row the paged arena could no longer
        grow (see ``_dispatch``): fail its stream, free its slot, and
        let the rest of the batch keep decoding."""
        if sess is None or sess.finished:
            return
        sess.finished = True
        obs.event("shed_kv_oom", sid=sess.sid, at="page_boundary")
        sess.stream.fail(KVPoolExhaustedError(
            f"decode session {sess.sid} shed at a page boundary: the "
            f"paged KV arena has no free page (size n_pages for the "
            f"working set, or admit fewer concurrent sessions)"))
        self.sessions[sess.slot] = None
        self.pool.free(sess.slot)
        self._done(sess, "shed_kv_oom")

    def _done(self, sess: DecodeSession, reason: str) -> None:
        with self._lock:
            if reason == "shed_deadline":
                self._n_shed_deadline += 1
            elif reason == "shed_kv_oom":
                self._n_shed_kv_oom += 1
            else:
                self._n_finished += 1
        cb = self.on_session_done
        if cb is not None:
            cb(sess, reason)

    def fail_pending(self, exc: BaseException, *,
                     only: Callable | None = None) -> list[DecodeSession]:
        """Fail not-yet-joined sessions (runtime shutdown path).  With
        ``only``, fail just the sessions that predicate selects — a
        closing runtime must not kill sessions OTHER producers (e.g. a
        concurrent blocking generate()) still have queued."""
        with self._lock:
            if only is None:
                left, self._pending = list(self._pending), deque()
            else:
                left = [s for s in self._pending if only(s)]
                self._pending = deque(s for s in self._pending
                                      if not only(s))
        for sess in left:
            sess.finished = True
            sess.stream.fail(exc)
        return left

    def fail_all(self, exc: BaseException, *,
                 only: Callable | None = None) -> list[DecodeSession]:
        """Fail pending AND in-flight sessions (a ticker died and will
        never resolve them).  ``only`` scopes the kill to one producer's
        sessions; the in-flight step is dropped only on a full
        (unfiltered) teardown."""
        failed = self.fail_pending(exc, only=only)
        with self._tick_lock:                  # a generate() may be mid-tick
            if only is None:
                self._inflight = None
            for slot, sess in enumerate(self.sessions):
                if sess is not None and (only is None or only(sess)):
                    sess.finished = True
                    sess.stream.fail(exc)
                    self.sessions[slot] = None
                    self.pool.free(slot)
                    failed.append(sess)
            if self._epoch is not None and only is None:
                e, self._epoch = self._epoch, None
                self.engine.unpin_epoch(e)
        return failed

    # ---------------------------------------------------------------- stats --
    def reset_stats(self) -> None:
        """Start a fresh stats window (counters, percentiles, and the
        wall-clock span all restart; in-flight sessions keep running)."""
        with self._lock:
            self._n_sessions = 0
            self._n_finished = 0
            self._n_shed_deadline = 0
            self._n_shed_kv_oom = 0
            self._n_tokens = 0
            self._n_steps = 0
            self._n_prefill_skipped = 0
            self._occupancy_sum = 0.0
            self._h_ttft.reset()
            self._h_itl.reset()
            self._t_first = None
            self._t_last = None

    def stats(self) -> DecodeStats:
        with _PREFILL_LOCK:
            prefill_compiles = list(_PREFILL_COMPILES.items())
        # quantiles off the bounded reservoirs, OUTSIDE self._lock
        ttft = tuple(v * 1e3 for v in self._h_ttft.quantile((50, 95, 99)))
        itl = tuple(v * 1e3 for v in self._h_itl.quantile((50, 95, 99)))
        with self._lock:
            wall = ((self._t_last - self._t_first)
                    if self._t_first is not None and self._t_last is not None
                    else 0.0)
            return DecodeStats(
                n_sessions=self._n_sessions,
                n_finished=self._n_finished,
                n_shed_deadline=self._n_shed_deadline,
                n_tokens=self._n_tokens,
                n_steps=self._n_steps,
                slot_occupancy=(self._occupancy_sum / self._n_steps
                                if self._n_steps else 0.0),
                ttft_p50_ms=ttft[0], ttft_p95_ms=ttft[1],
                ttft_p99_ms=ttft[2],
                itl_p50_ms=itl[0], itl_p95_ms=itl[1], itl_p99_ms=itl[2],
                tokens_per_s=(self._n_tokens / wall if wall > 0 else 0.0),
                wall_s=wall,
                n_prefill_skipped=self._n_prefill_skipped,
                n_prefill_compiles=sum(
                    n for (name, _), n in prefill_compiles
                    if name == self.cfg.name),
                n_prefill_buckets=sum(
                    1 for (name, _), _n in prefill_compiles
                    if name == self.cfg.name),
                prefix_hit_rate=(
                    self.pool.prefix_hits
                    / (self.pool.prefix_hits + self.pool.prefix_misses)
                    if self.pool.layout == "paged"
                    and (self.pool.prefix_hits + self.pool.prefix_misses)
                    else math.nan),
                kv_pages_in_use=self.pool.pages_in_use,
                kv_peak_pages=self.pool.peak_pages_in_use,
                n_shed_kv_oom=self._n_shed_kv_oom,
            )
