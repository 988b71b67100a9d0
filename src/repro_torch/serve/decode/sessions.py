"""Decode sessions and per-token streaming futures (counterpart of
``repro.serve.decode.sessions``, the same code).

A :class:`DecodeSession` is one in-flight generation request: a prompt,
greedy sampling bounds (``max_new_tokens``, optional ``eos_id``), and the
:class:`TokenStream` the scheduler resolves token by token.  The stream
is the decode-side analogue of ``runtime.future.RankFuture`` — but where
a rank request resolves ONCE, a decode session resolves ``max_new_tokens``
times, so the stream is a write-many/read-many object:

  * the producer (the :class:`~repro_torch.serve.decode.DecodeScheduler`, or
    the shed path) calls ``append`` per token and ``finish``/``fail``
    exactly once;
  * consumers iterate tokens as they land (``for tok in stream``), poll
    (``get(i)``), or block for the whole sequence (``result()``);
  * per-token timestamps live on the stream, so time-to-first-token and
    inter-token latency are computed from the same object that carried
    the tokens — no side table.

Timing metadata (``t_submit``, ``deadline``) mirrors ``RankFuture`` so
the runtime's admission control (queue-full shed, deadline shed) applies
to decode sessions exactly as it does to scoring requests.
"""

from __future__ import annotations

import threading
import time

import numpy as np

__all__ = ["TokenStream", "DecodeSession", "FINISH_REASONS"]

#: Terminal states a stream can reach: ``eos`` (the session's eos_id was
#: produced), ``max_tokens`` (the token budget ran out), ``error`` (shed
#: or failed — ``exception()`` carries the reason).
FINISH_REASONS = ("eos", "max_tokens", "error")


class TokenStream:
    """Write-many future: one slot per generated token, resolved in order.

    Thread-safe: the scheduler appends from the dispatcher thread while
    any number of consumer threads iterate/wait.
    """

    def __init__(self, sid: int, t_submit: float | None = None,
                 deadline: float | None = None):
        self.sid = sid
        self.t_submit = (time.perf_counter() if t_submit is None
                         else t_submit)
        self.deadline = deadline          # absolute perf_counter, or None
        # observability span (set by the submitting front-end); closed
        # here at finish/fail so EVERY terminal path — eos, max_tokens,
        # deadline shed, shed_kv_oom, runtime close — closes it
        self.span = None
        self._tokens: list[int] = []
        self._times: list[float] = []     # perf_counter per appended token
        self._finish_reason: str | None = None
        self._exc: BaseException | None = None
        self._cond = threading.Condition()

    # -- producer side (scheduler / shed path) ----------------------------
    def append(self, token: int, t: float | None = None) -> None:
        with self._cond:
            assert self._finish_reason is None, \
                f"stream {self.sid} appended after finish"
            self._tokens.append(int(token))
            self._times.append(time.perf_counter() if t is None else t)
            first = len(self._tokens) == 1
            self._cond.notify_all()
        if first and self.span is not None:
            self.span.event("first_token")

    def finish(self, reason: str) -> None:
        assert reason in FINISH_REASONS, reason
        with self._cond:
            assert self._finish_reason is None, \
                f"stream {self.sid} finished twice"
            self._finish_reason = reason
            n = len(self._tokens)
            self._cond.notify_all()
        if self.span is not None:         # outside _cond: span lock is leaf
            self.span.end("ok", reason=reason, n_tokens=n)

    def fail(self, exc: BaseException) -> None:
        with self._cond:
            if self._finish_reason is not None:
                return                    # already terminal; keep tokens
            self._exc = exc
            self._finish_reason = "error"
            n = len(self._tokens)
            self._cond.notify_all()
        if self.span is not None:
            self.span.set(n_tokens=n)
            self.span.end_from_exc(exc)

    # -- consumer side -----------------------------------------------------
    def done(self) -> bool:
        with self._cond:
            return self._finish_reason is not None

    @property
    def finish_reason(self) -> str | None:
        with self._cond:
            return self._finish_reason

    def exception(self, timeout: float | None = None) -> BaseException | None:
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._finish_reason is not None, timeout):
                raise TimeoutError(f"stream {self.sid} not finished "
                                   f"within {timeout}s")
            return self._exc

    def __len__(self) -> int:
        with self._cond:
            return len(self._tokens)

    def get(self, i: int, timeout: float | None = None) -> int:
        """Block until token ``i`` exists (raises if the stream finishes
        first with fewer tokens, re-raising the failure reason if any)."""
        with self._cond:
            if not self._cond.wait_for(
                    lambda: len(self._tokens) > i
                    or self._finish_reason is not None, timeout):
                raise TimeoutError(f"stream {self.sid}: token {i} not "
                                   f"resolved within {timeout}s")
            if len(self._tokens) > i:
                return self._tokens[i]
            if self._exc is not None:
                raise self._exc
            raise IndexError(
                f"stream {self.sid} finished ({self._finish_reason}) "
                f"after {len(self._tokens)} tokens; no token {i}")

    def __iter__(self):
        """Yield tokens in order as they resolve; stops at finish.  A
        failed stream re-raises its reason after the tokens that did
        land."""
        i = 0
        while True:
            try:
                yield self.get(i)
            except IndexError:
                return
            i += 1

    def result(self, timeout: float | None = None) -> np.ndarray:
        """Block for the full sequence; int32 [n_tokens]."""
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._finish_reason is not None, timeout):
                raise TimeoutError(f"stream {self.sid} not finished "
                                   f"within {timeout}s")
            if self._exc is not None:
                raise self._exc
            return np.asarray(self._tokens, np.int32)

    def tokens_so_far(self) -> np.ndarray:
        with self._cond:
            return np.asarray(self._tokens, np.int32)

    # -- timing ------------------------------------------------------------
    def ttft_s(self) -> float | None:
        """Submit -> first token, or None before the first token."""
        with self._cond:
            if not self._times:
                return None
            return self._times[0] - self.t_submit

    def inter_token_s(self) -> np.ndarray:
        """Gaps between consecutive token arrivals ([n-1] float64)."""
        with self._cond:
            return np.diff(np.asarray(self._times, np.float64))

    def __repr__(self) -> str:            # pragma: no cover - debug aid
        with self._cond:
            state = self._finish_reason or "streaming"
            return (f"TokenStream(sid={self.sid}, n={len(self._tokens)}, "
                    f"{state})")


class DecodeSession:
    """One generation request moving through the scheduler.

    ``prompt`` is a 1-D int32 token array; the session emits up to
    ``max_new_tokens`` greedy tokens (the first comes from the prefill's
    final hidden state, the rest from pooled decode steps), stopping
    early when ``eos_id`` is produced.
    """

    __slots__ = ("sid", "prompt", "max_new_tokens", "eos_id", "stream",
                 "slot", "n_emitted", "finished", "owner")

    def __init__(self, sid: int, prompt, max_new_tokens: int,
                 eos_id: int | None = None,
                 t_submit: float | None = None,
                 deadline: float | None = None):
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.shape[0] < 1:
            raise ValueError(
                f"prompt must be a non-empty 1-D token array, "
                f"got shape {prompt.shape}")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self.sid = sid
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.stream = TokenStream(sid, t_submit=t_submit, deadline=deadline)
        self.slot: int | None = None
        self.n_emitted = 0
        self.finished = False
        # which front-end admitted the session (the AsyncRuntime tags
        # sessions it owns so its accounting ignores sessions other
        # producers — e.g. a concurrent blocking generate() — submit
        # to the same scheduler)
        self.owner: object | None = None
