"""Continuous micro-batcher: coalesce requests into bucketed batch shapes
(counterpart of ``repro.serve.batcher``, the same code).

A captured CUDA graph holds one input shape (as an XLA program does), so
a naive serving loop that batches "whatever arrived" would capture anew
whenever the arrival pattern changes.  The batcher quantises every
coalesced batch to a fixed bucket ladder (powers of two by default) and
pads to the bucket, so after warm-up each (head, bucket) pair is built
exactly once regardless of traffic shape.

Pure shape logic — no torch, no engine state — so it is unit-testable
and reusable by any caller that owns its own step cache.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

__all__ = ["Chunk", "MicroBatcher", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


class Chunk(NamedTuple):
    """One jit-shaped unit of work: requests [start, start+size) padded to
    ``bucket`` rows."""

    start: int
    size: int
    bucket: int


class MicroBatcher:
    """Maps "n requests are waiting" to a static-shape execution plan."""

    def __init__(self, buckets: Sequence[int] = DEFAULT_BUCKETS):
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"bad bucket ladder: {buckets}")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.max_bucket = self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (n must not exceed the max bucket)."""
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"{n} exceeds max bucket {self.max_bucket}")

    def plan(self, n: int) -> list[Chunk]:
        """Split n queued requests into chunks: greedy max-bucket chunks,
        then one bucketed remainder chunk."""
        chunks: list[Chunk] = []
        start = 0
        while n - start >= self.max_bucket:
            chunks.append(Chunk(start, self.max_bucket, self.max_bucket))
            start += self.max_bucket
        rest = n - start
        if rest:
            chunks.append(Chunk(start, rest, self.bucket_for(rest)))
        return chunks

    @staticmethod
    def pad_rows(x, bucket: int, fill=0):
        """Pad axis 0 of an array (or each leaf of a dict) to ``bucket``
        rows with ``fill``; numpy-side so device buffers stay static."""
        if isinstance(x, dict):
            return {k: MicroBatcher.pad_rows(v, bucket, fill)
                    for k, v in x.items()}
        arr = np.asarray(x)
        n = arr.shape[0]
        if n == bucket:
            return arr
        pad = np.full((bucket - n,) + arr.shape[1:], fill, arr.dtype)
        return np.concatenate([arr, pad], axis=0)
