"""Serving subpackage (counterpart of ``repro.serve``'s score path):
unified batched engine + pluggable WOL heads + the async serving runtime.

  * ``engine``  — :class:`Engine` (submit/flush/metrics), plus the legacy
    ``WOLServer`` facade.
  * ``heads``   — the full | lss head protocol.
  * ``batcher`` — bucketed continuous micro-batching (pure shape logic).
  * ``step``    — one (head, bucket) step: a captured CUDA graph on the
    card, an eager call on the CPU.
  * ``runtime`` — :class:`AsyncRuntime`: thread-safe admission queue with
    per-request futures, deadline/queue-depth load shedding, and a
    dispatcher that overlaps host-side padding with device execution.

Streaming decode, the vocab-sharded heads and multi-process serving come
with later slices of the port.
"""

from repro_torch.serve.batcher import DEFAULT_BUCKETS, Chunk, MicroBatcher
from repro_torch.serve.engine import (Engine, RankResult, ServeMetrics,
                                      WOLServer)
from repro_torch.serve.heads import (HEAD_KINDS, HeadOutput, make_full_head,
                                     make_lss_head)
from repro_torch.serve.runtime import (AdmissionQueue, AsyncRuntime,
                                       DeadlineExceededError, QueueFullError,
                                       RankFuture, RuntimeClosedError,
                                       RuntimeStats, ShedError,
                                       submit_open_loop)

__all__ = [
    "DEFAULT_BUCKETS", "Chunk", "MicroBatcher",
    "Engine", "RankResult", "ServeMetrics", "WOLServer",
    "HEAD_KINDS", "HeadOutput", "make_full_head", "make_lss_head",
    "AsyncRuntime", "RuntimeStats", "RankFuture", "AdmissionQueue",
    "ShedError", "QueueFullError", "DeadlineExceededError",
    "RuntimeClosedError", "submit_open_loop",
]
