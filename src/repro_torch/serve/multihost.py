"""Multi-process serving: process 0 owns admission, followers mirror
(counterpart of ``repro.serve.multihost``).

Topology (``distributed.ServingMesh``): one (host, model) layout of the
fleet's ranks — hosts of ``LOCAL_WORLD_SIZE`` ranks, one rank a device —
so vocab shards are host-contiguous, exactly what the hierarchical top-k
merge's global-id offsets assume.  Every rank builds ONLY the shards it
holds (``heads.shard_index(..., shard_range=...)``); no rank stitches a
global stack (the JAX package's ``assemble_global_stack``): a rank's
shards are its own tensors.

Control plane: the AsyncRuntime, the admission queue, deadlines, and
result futures live on process 0 only.  A sharded step ends in
collectives (the merge), so before the leader runs one, every follower
must enter the same step with the same batch.  The seam is
``Engine._step`` — the ONE choke point both ``Engine.rank``/``flush``
and the AsyncRuntime dispatcher fetch steps from — which on the leader
returns a step (:func:`make_leader_step`) that first ships one opcode
message — an [4]-int32 header ``(opcode, head, rows, dim)`` plus the
padded batch — over :class:`_OpChannel` and then runs the step;
followers sit in :func:`follower_loop` replaying the opcode stream until
``OP_STOP``.  The follower side of the channel is a single thread, so
every leader-side send sequence holds ``MultihostContext.lock`` end to
end (message + step) — without it two leader threads (the AsyncRuntime
dispatcher and, say, the RecallAuditor's background
``rank(head="full")``) could interleave their messages and desync the
whole fleet.

The channel rides the process group's ``TCPStore`` (or the store the
fleet started over), NOT gloo collectives.  The JAX package learned this
the hard way: a stream of tiny broadcast collectives beside the step's
own collectives could overlap across processes under CPU contention and
collide on a gloo slot (a fatal ``gloo ... op.preamble.length <=
op.nbytes`` abort: a 4-byte receive matched against a segment of the
batch).  With the control plane on the store, the only collectives left
are the steps' merges, which the channel strictly serialises.

Decode rides the same channel at session granularity: ``OP_DECODE``
ships the prompt block once, then EVERY process runs the same
deterministic blocking ``LMDecoder.generate`` — the fused decode steps'
merges run in lockstep without per-token messages, because blocking
generate has no wall-clock-dependent control flow.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import io
import os
import threading

import numpy as np
import torch.distributed as dist

from repro_torch.distributed import (DIST_NUM_PROCESSES_ENV, ServingMesh,
                                     distributed_store, init_distributed,
                                     make_serving_mesh)
from repro_torch.serve.engine import host_numpy
from repro_torch.testing import faults

__all__ = ["MultihostContext", "init_multihost", "make_leader_step",
           "leader_generate", "leader_swap_index", "follower_loop",
           "stop_followers", "mirrored_region", "in_mirrored_region",
           "OP_STOP", "OP_SCORE", "OP_DECODE", "OP_SWAP_INDEX"]

OP_STOP, OP_SCORE, OP_DECODE, OP_SWAP_INDEX = 0, 1, 2, 3
_HEAD_IDS = {"full": 0, "lss": 1, "lss-sharded": 2}
_ID_HEADS = {v: k for k, v in _HEAD_IDS.items()}


def _pack(arrays) -> bytes:
    """Serialize a tuple of arrays (dtype/shape/bytes verbatim)."""
    bio = io.BytesIO()
    np.savez(bio, **{f"a{i}": np.asarray(a) for i, a in enumerate(arrays)})
    return bio.getvalue()


def _unpack(blob: bytes) -> list[np.ndarray]:
    with np.load(io.BytesIO(blob)) as z:
        return [z[f"a{i}"] for i in range(len(z.files))]


class _OpChannel:
    """Leader -> followers opcode messaging over a ``torch.distributed``
    store (see the module docstring for why this must NOT be gloo
    collectives).

    One message per opcode: a monotonically increasing sequence number
    keys each blob, the leader's sends and every follower's receives
    advance their local counters in lockstep (a follower consumes exactly
    one message per leader send), and payload bytes travel verbatim —
    followers see the leader's batch bit-identically.  The leader deletes
    keys ``_GC_WINDOW`` sends behind, so a long-lived serving fleet
    cannot grow the store without bound (a follower lagging 4096 whole
    opcodes is a broken fleet, not a slow one)."""

    _PREFIX = "repro/opch"
    _GC_WINDOW = 4096

    def __init__(self, store):
        self._store = dist.PrefixStore(self._PREFIX, store)
        self.seq = 0                   # messages sent or received so far

    def send(self, *arrays) -> None:
        self.seq += 1
        self._store.set(str(self.seq), _pack(arrays))
        old = self.seq - self._GC_WINDOW
        if old > 0:
            self._store.delete_key(str(old))

    def recv(self, timeout_s: float | None = 600.0) -> list[np.ndarray]:
        """Block for the next message.  ``None`` waits forever (an idle
        follower between requests), in bounded waits of a minute, so no
        store deadline fires on a quiet channel."""
        self.seq += 1
        key = str(self.seq)
        chunk = datetime.timedelta(
            seconds=60.0 if timeout_s is None else timeout_s)
        while True:
            try:
                self._store.wait([key], chunk)
                break
            except RuntimeError as exc:   # retry only a wait's timeout
                if timeout_s is None and "timeout" in str(exc).lower():
                    continue
                raise
        return _unpack(self._store.get(key))

    def holds(self, seq: int) -> bool:
        """Whether message ``seq`` is still in the store."""
        return self._store.check([str(seq)])


@dataclasses.dataclass(frozen=True)
class MultihostContext:
    """The fleet's shape, shared by engine, launcher, and bench.

    ``lock`` serialises the leader's opcode channel: followers replay
    opcodes strictly in sequence order, entering each step's collectives
    as they go, so a leader thread's send+step sequence must never
    interleave with another thread's (the swap's message pair and the
    collectives inside each step would cross).  Reentrant, because a
    mirrored decode holds it across ``generate`` while the inner prefill
    re-enters the step wrapper on the same thread."""

    mesh: ServingMesh
    channel: _OpChannel = dataclasses.field(repr=False, compare=False)
    lock: threading.RLock = dataclasses.field(
        default_factory=threading.RLock, repr=False, compare=False)

    @property
    def process_id(self) -> int:
        return self.mesh.rank

    @property
    def n_processes(self) -> int:
        return self.mesh.world

    @property
    def n_shards(self) -> int:
        return self.mesh.n_shards

    @property
    def is_leader(self) -> bool:
        return self.process_id == 0

    def shard_range(self) -> tuple[int, int]:
        """[lo, hi) shard ids this process holds (host-contiguous)."""
        return self.mesh.shard_range()

    def row_range(self, m: int) -> tuple[int, int]:
        """Global weight rows [r0, r1) this process's shards cover for a
        vocab of m — the ONLY rows it needs to hold."""
        return self.mesh.row_range(m)


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, *,
                   device=None, store=None) -> MultihostContext | None:
    """Start the fleet (``distributed.init_distributed``: the arguments
    default to the ``REPRO_DIST_COORDINATOR``-family variables) and build
    the serving mesh and opcode channel.  Returns None in the
    single-process case (fewer than two processes): callers branch once
    and the whole single-process path stays untouched."""
    if num_processes is None:
        num_processes = int(os.environ.get(DIST_NUM_PROCESSES_ENV, "1"))
    if num_processes <= 1:
        return None
    if not init_distributed(coordinator, num_processes, process_id,
                            device=device, store=store):
        return None
    return MultihostContext(make_serving_mesh(),
                            _OpChannel(distributed_store()))


# ------------------------------------------------------ opcode channel --
_MIRROR = threading.local()


def in_mirrored_region() -> bool:
    return getattr(_MIRROR, "depth", 0) > 0


@contextlib.contextmanager
def mirrored_region():
    """Marks a region EVERY process executes in lockstep (mirrored
    decode): inside it the leader's step wrapper stands down — nobody is
    waiting on the opcode channel, because the followers are running this
    very region themselves.  Without this, the decode prefill's
    ``engine.rank`` on the leader would send OP_SCORE at a follower that
    is inside its own mirrored ``generate`` — a deadlock."""
    _MIRROR.depth = getattr(_MIRROR, "depth", 0) + 1
    try:
        yield
    finally:
        _MIRROR.depth -= 1


def _header(op: int, kind_id: int, rows: int, dim: int) -> np.ndarray:
    return np.asarray([op, kind_id, rows, dim], np.int32)


class _LeaderStep:
    """A score step on the leader: ship the opcode + batch so every
    follower enters the same step (and its merge's collectives), then run
    it — the whole sequence under ``ctx.lock``, so concurrent leader
    threads (the AsyncRuntime dispatcher, the RecallAuditor, user
    threads) never interleave opcodes on the single-threaded follower
    channel.  ``step`` is the wrapped :class:`serve.step.Step`."""

    def __init__(self, ctx: MultihostContext, step, kind: str):
        self.ctx = ctx
        self.step = step
        self.kind_id = _HEAD_IDS[kind]

    @property
    def captured(self) -> bool:
        return self.step.captured

    def __call__(self, padded):
        if in_mirrored_region():
            # every process runs this same code in lockstep: no message,
            # the batch is the same everywhere; on the leader ctx.lock is
            # already held by leader_generate
            return self.step(padded)
        x = np.asarray(host_numpy(padded), np.float32)
        if x.ndim != 2:
            raise ValueError(
                "multihost serving scores raw [B, d] embedding batches "
                f"(embed_fn=None engines); got shape {x.shape}")
        with self.ctx.lock:
            self.ctx.channel.send(
                _header(OP_SCORE, self.kind_id, x.shape[0], x.shape[1]), x)
            # the merge's collectives complete inside the lock: the next
            # opcode is not sent before this step has run on every rank
            return self.step(x)


def make_leader_step(ctx: MultihostContext, step, kind: str
                     ) -> _LeaderStep:
    """Wrap a score step for the leader (see :class:`_LeaderStep`).  The
    JAX function's bucket argument, which it never reads, is dropped."""
    return _LeaderStep(ctx, step, kind)


def leader_generate(ctx: MultihostContext, decoder, prompt, steps: int,
                    head: str):
    """Blocking decode on the whole fleet: ship the session block, then
    run the same deterministic ``generate`` everywhere (followers pick it
    up via OP_DECODE in :func:`follower_loop`)."""
    prompt = np.asarray(host_numpy(prompt), np.int32)
    with ctx.lock:
        ctx.channel.send(
            _header(OP_DECODE, _HEAD_IDS[head], prompt.shape[0],
                    prompt.shape[1]),
            np.asarray([steps], np.int32), prompt)
        # hold the lock across the mirrored generate too: its fused
        # decode steps' merges run fleet-wide collectives, so another
        # leader thread sending OP_SCORE mid-decode would interleave
        # collectives across processes
        with mirrored_region():
            return decoder.generate(prompt, steps=steps, head=head)


def leader_swap_index(ctx: MultihostContext, engine, index) -> int:
    """Fleet-wide online index swap (``Engine.swap_index`` routes here on
    the leader).  Two-phase over the opcode channel: ship the
    hyperplanes, then a commit flag — followers rebuild the index
    deterministically from theta against their own weights (bit-identical
    by ``build_index`` determinism, no bucket arrays shipped) and flip
    only on commit=1.  If the leader fails between payload and commit
    (the ``multihost.swap_commit`` fault window), it sends commit=0 on
    the way out and EVERY process stays on the serving epoch — a swap is
    all-or-nothing, never split-brain.

    Holding ``ctx.lock`` across the whole sequence keeps the swap's
    message pair from interleaving with a score/decode opcode, which also
    means no score step can run BETWEEN a follower's flip and the
    leader's — the fleet is epoch-consistent at every opcode boundary."""
    theta = np.asarray(host_numpy(index.theta), np.float32)
    with ctx.lock:
        ctx.channel.send(
            _header(OP_SWAP_INDEX, 0, theta.shape[0], theta.shape[1]),
            theta)
        try:
            faults.fire(faults.MULTIHOST_SWAP_COMMIT)
            ctx.channel.send(np.asarray([1], np.int32))
        except BaseException:
            # abort: tell the fleet to discard the payload and stay on
            # the old epoch, then surface the failure to the refresher
            ctx.channel.send(np.asarray([0], np.int32))
            raise
        # the leader flips INSIDE the lock: the next opcode can only be
        # sent after both sides flipped
        return engine._swap_prepared(engine.prepare_epoch(index))


def stop_followers(ctx: MultihostContext) -> None:
    """Leader: release every follower_loop (call once, when done)."""
    with ctx.lock:
        ctx.channel.send(_header(OP_STOP, 0, 0, 0))


def follower_loop(engine, ctx: MultihostContext, decoder=None,
                  max_ops: int | None = None) -> int:
    """Run on every non-leader process: replay the leader's opcode stream
    — entering the same steps with the same payloads — until OP_STOP (or
    ``max_ops``).  Returns ops executed.

    The engine (and decoder, when decode traffic is expected) must be
    constructed as the leader's — same weights, same fitted index — which
    deterministic seeds give; the shards are built from LOCAL rows, so
    "the same" never means shipping the full [m, d] weight anywhere.
    """
    if ctx.is_leader:
        raise RuntimeError("follower_loop on the leader would deadlock "
                           "waiting for its own opcode")
    n_ops = 0
    while max_ops is None or n_ops < max_ops:
        msg = ctx.channel.recv(timeout_s=None)
        op, kind_id, rows, dim = (int(v) for v in msg[0])
        if op == OP_STOP:
            break
        n_ops += 1
        kind = _ID_HEADS[kind_id]
        if op == OP_SCORE:
            engine._step(kind, rows)(msg[1])
        elif op == OP_DECODE:
            steps, prompt = int(msg[1][0]), msg[2]
            if decoder is None:
                raise RuntimeError("OP_DECODE received but follower has "
                                   "no decoder to mirror generate on")
            with mirrored_region():
                decoder.generate(prompt, steps=steps, head=kind)
        elif op == OP_SWAP_INDEX:
            theta = msg[1]
            commit = int(ctx.channel.recv(timeout_s=None)[0][0])
            if commit:
                engine.swap_from_theta(theta)
            # commit=0: the leader aborted mid-swap — drop theta, keep
            # serving the current epoch
        else:
            raise RuntimeError(f"unknown multihost opcode {op}")
    return n_ops
