"""Serving subpackage (counterpart of ``repro.serve``): unified batched
engine + pluggable WOL heads + streaming decode + the async serving
runtime.

  * ``engine``  — :class:`Engine` (submit/flush/metrics, ``decode_logits``),
    the legacy ``WOLServer`` facade and :class:`LMDecoder`.
  * ``heads``   — the full | lss | lss-sharded head protocol and
    ``shard_index``.
  * ``batcher`` — bucketed continuous micro-batching (pure shape logic).
  * ``step``    — one (head, bucket) step or fused decode step: a captured
    CUDA graph on the card, an eager call on the CPU.
  * ``decode``  — streaming decode: sessions, the KV pool (dense | paged),
    the continuous-batching :class:`DecodeScheduler`.
  * ``runtime`` — :class:`AsyncRuntime`: thread-safe admission queue with
    per-request futures, deadline/queue-depth load shedding, and a
    dispatcher that overlaps host-side padding with device execution.
  * ``multihost`` — multi-process serving: the leader's opcode channel
    over the fleet's store, ``follower_loop``, the guarded fleet swap.
"""

from repro_torch.serve.batcher import DEFAULT_BUCKETS, Chunk, MicroBatcher
from repro_torch.serve.decode import (FINISH_REASONS, DecodeScheduler,
                                      DecodeSession, DecodeStats, KVCachePool,
                                      KVPoolExhaustedError, TokenStream)
from repro_torch.serve.engine import (Engine, LMDecoder, RankResult,
                                      ServeMetrics, WOLServer)
from repro_torch.serve.heads import (HEAD_KINDS, HeadOutput, make_full_head,
                                     make_lss_head, make_multihost_lss_head,
                                     make_sharded_lss_head, shard_index)
from repro_torch.serve.runtime import (AdmissionQueue, AsyncRuntime,
                                       DeadlineExceededError, QueueFullError,
                                       RankFuture, RuntimeClosedError,
                                       RuntimeStats, ShedError,
                                       submit_decode_open_loop,
                                       submit_open_loop)

__all__ = [
    "DEFAULT_BUCKETS", "Chunk", "MicroBatcher",
    "Engine", "RankResult", "ServeMetrics", "WOLServer", "LMDecoder",
    "HEAD_KINDS", "HeadOutput", "make_full_head", "make_lss_head",
    "make_sharded_lss_head", "make_multihost_lss_head", "shard_index",
    "AsyncRuntime", "RuntimeStats", "RankFuture", "AdmissionQueue",
    "ShedError", "QueueFullError", "DeadlineExceededError",
    "RuntimeClosedError", "submit_open_loop", "submit_decode_open_loop",
    "DecodeScheduler", "DecodeStats", "DecodeSession", "TokenStream",
    "FINISH_REASONS", "KVCachePool", "KVPoolExhaustedError",
]
