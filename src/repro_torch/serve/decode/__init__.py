"""Continuous-batching streaming decode (counterpart of
``repro.serve.decode``).

  * ``sessions``  — :class:`DecodeSession` (one generation request) and
    :class:`TokenStream` (write-many per-token future with TTFT /
    inter-token timing).
  * ``kv_pool``   — :class:`KVCachePool`: KV storage behind one slot
    API, in two layouts (the ``kv_pool.layout`` strategy /
    ``$REPRO_KV_LAYOUT``): ``dense`` fixed ``[L, max_streams, max_len,
    KV, H]`` slabs, or ``paged`` — a ``[L, n_pages, page_tokens, KV,
    H]`` arena + host page tables (``$REPRO_KV_PAGE_TOKENS``), with
    refcounted prefix-shared prompt pages and copy-on-write at
    divergence.  Sessions join a free slot after prefill and leave on
    EOS / token budget, so batch composition changes with zero rebuilds
    — in either layout.
  * ``scheduler`` — :class:`DecodeScheduler`: one fused
    ``decode_step_pooled | decode_step_paged -> Engine head`` step over
    all slots (a CUDA graph on the card), software-pipelined one step
    deep, token-exact with the blocking per-stream loop (and across
    layouts).  Prefill pads prompts to power-of-two buckets, and a fully
    prefix-cached prompt skips prefill outright.

Hangs behind :class:`repro_torch.serve.AsyncRuntime` via
``submit_decode`` (admission queue, block|shed, deadlines) or runs
standalone via ``DecodeScheduler.submit`` / ``run``.

Invariants:

* **Dispatch snapshots are copied.** ``_dispatch`` materialises the
  active ``[(slot, session)]`` list into the in-flight record: a session
  can retire and its slot be re-admitted by a NEW session while the step
  is still on the device, and emitting that step's token to the new
  occupant would corrupt both streams.
* **The blocking facade shares the pooled step shape.** ``generate``
  submits into the same fixed ``max_streams``-row scheduler the
  streaming path uses, because batch shape changes GEMM results (on the
  CPU and in cuBLAS): a ``[batch]``-shaped step would give ulp-level
  different logits.
* **Per-row lengths, one step.** Batch composition only changes the
  ``lengths`` operand and the token rows, never a shape.
* **Both layouts attend through one op.** ``decode_attention`` reads
  each row's valid positions through its page table (a dense slab is an
  arena of one ``max_len`` page a row), so both layouts run the same
  reduction over the same valid contents and paged decode is
  BIT-identical to dense.  Page 0 of the arena is reserved scratch:
  unmapped table entries and parked rows' writes land there; a row at
  ``max_len`` writes nothing.
* **One stream.** The KV slabs are updated in place (by the step's
  graph and by joins), all on the device's current stream, which orders
  a join behind the in-flight step.
"""

from repro_torch.serve.decode.kv_pool import KVCachePool, KVPoolExhaustedError
from repro_torch.serve.decode.scheduler import DecodeScheduler, DecodeStats
from repro_torch.serve.decode.sessions import (FINISH_REASONS, DecodeSession,
                                               TokenStream)

__all__ = ["KVCachePool", "KVPoolExhaustedError", "DecodeScheduler",
           "DecodeStats", "DecodeSession", "TokenStream", "FINISH_REASONS"]
