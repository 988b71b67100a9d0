"""KV-cache pool for continuous-batching decode: dense slabs or paged
storage behind one slot API (counterpart of
``repro.serve.decode.kv_pool``).

Two storage layouts, selected by the ``kv_pool.layout`` registry strategy
(``REPRO_KV_LAYOUT`` = ``dense`` | ``paged``):

**dense** — fixed-shape slabs ``[n_layers, max_streams, max_len,
n_kv_heads, head_dim]``: every slot reserves ``max_len`` rows up front,
so capacity is ``max_streams`` regardless of how short sessions are.

**paged** — one ``[n_layers, n_pages, page_tokens, KV, H]`` arena per
cache side plus a host-side ``[max_streams, pages_per_slot]`` page table:
sessions map fixed-size pages on demand (at join, and as decode crosses a
page boundary), so pool capacity becomes sessions-per-GB instead of
``max_streams × max_len``.  Page 0 is a reserved scratch page — it is
never allocated, unmapped page-table entries point at it, and in-flight
writes from parked rows land there, so a freed session's lagged step can
never corrupt a page that has been recycled to a new session.

On top of the page table the paged layout adds **prefix caching**:
prompt pages are content-addressed (key = the full token prefix the
page's KV depends on, plus the prefill bucket — KV is only
bit-reproducible within one prefill reduction shape), so sessions joining
with an identical prompt prefix share read-only pages, and an identical
*full* prompt lets the scheduler skip prefill entirely
(:meth:`KVCachePool.join_from_cache`).  Sharing is safe while the donor
still decodes because KV pages are append-only: a session only ever
writes at offsets >= its own prompt length, and the page a new session
must write into (the partial remainder page) is copy-on-write at join.
Cache-held pages persist after their sessions leave (the cache holds one
reference) and are evicted LRU under page pressure.

Token exactness: both layouts' decode steps attend through one op,
``kernels.decode_attention`` (see ``models.transformer.decode_step_paged``),
which reads each row's valid positions through its page table (a dense
slab is an arena of one ``max_len`` page a row).  On the card the kernel
splits a row at absolute positions and its result depends on that row's
data only; on the CPU its plain version gathers the pages in order into
a ``[max_len]``-wide view, the dense slab's shape.  Either way paged
decode is bit-identical to dense.

Slot state is split across the device/host boundary deliberately:

  * the slabs/arenas (``k``/``v``) live on the device and are updated IN
    PLACE: by the scheduler's fused step (a CUDA graph on the card, which
    captured these very tensors) and by the join scatters below.  All of
    them are issued on the device's current stream, so a join issued
    after step k's dispatch runs after step k on the device — the stream
    order takes the place of the JAX package's data flow;
  * per-slot lengths, the page table, page refcounts, and the prefix
    cache live on the HOST (numpy) — they are scheduler control state,
    copied into the step's operands every step.

A freed dense slot is simply abandoned in place; a freed paged slot
releases its page references (pages return to the free list once neither
a session nor the prefix cache holds them).
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.kernels import registry

__all__ = ["KVCachePool", "KVPoolExhaustedError", "KV_LAYOUTS",
           "KV_LAYOUT_ENV", "KV_PAGE_ENV"]


class KVPoolExhaustedError(RuntimeError):
    """The paged arena has no free page and nothing is evictable: every
    page is referenced by a live session.  Raised by ``join`` /
    ``join_from_cache`` (which unwind to the pre-call state first) so
    the scheduler can shed the ONE session that could not get a page
    instead of tearing down the whole tick."""


KV_LAYOUTS = ("dense", "paged")
KV_LAYOUT_ENV = "REPRO_KV_LAYOUT"
KV_PAGE_ENV = "REPRO_KV_PAGE_TOKENS"
DEFAULT_PAGE_TOKENS = 128

# registry-style strategy knob: explicit arg > set_default_strategy /
# use_strategy("kv_pool.layout", ...) > $REPRO_KV_LAYOUT > dense
_layout_strategy = registry.kernel_strategy(
    "kv_pool.layout", KV_LAYOUTS, env_var=KV_LAYOUT_ENV)


class KVCachePool:
    """Slot accounting + KV storage (dense slabs or a paged arena).

    Args:
      cfg: the TransformerConfig whose decode this pool backs.
      max_streams: slot count == rows of the fused step (a graph shape).
      max_len: logical cache width every session sees (the decode step
        attends over at most this many positions of a row, in either
        layout).
      dtype: cache dtype; defaults to ``cfg.dtype``.
      layout: ``dense`` | ``paged`` | None (resolve via the
        ``kv_pool.layout`` registry strategy / ``$REPRO_KV_LAYOUT``).
      page_tokens: paged layout page size; None reads
        ``$REPRO_KV_PAGE_TOKENS`` (default 128).
      n_pages: paged arena size INCLUDING the reserved scratch page;
        None sizes for dense parity (every slot can reach ``max_len``).
        Smaller values cap memory — sessions then share capacity: a
        join that cannot get a page raises :class:`KVPoolExhaustedError`
        (leaving the pool untouched), and ``advance`` reports the
        starved slots so the caller can shed just those sessions.
      device: where the slabs live (the GPU unless the caller asks for
        the CPU).
    """

    def __init__(self, cfg, max_streams: int, max_len: int,
                 dtype: torch.dtype | None = None, *,
                 layout: str | None = None, page_tokens: int | None = None,
                 n_pages: int | None = None,
                 device: str | torch.device | None = None):
        if max_streams < 1:
            raise ValueError(f"max_streams must be >= 1, got {max_streams}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_streams = int(max_streams)
        self.max_len = int(max_len)
        self.dtype = dtype or cfg.dtype
        self.layout = _layout_strategy.resolve(layout)
        self.lengths = np.zeros((max_streams,), np.int32)   # host mirror
        self._free = list(range(max_streams - 1, -1, -1))   # pop() -> slot 0
        if self.layout == "dense":
            shape = (cfg.n_layers, max_streams, max_len,
                     cfg.n_kv_heads, cfg.head_dim)
            self.k = torch.zeros(shape, dtype=self.dtype, device=self.device)
            self.v = torch.zeros(shape, dtype=self.dtype, device=self.device)
            return
        # ------------------------------------------------- paged layout --
        if page_tokens is None:
            page_tokens = int(os.environ.get(KV_PAGE_ENV)
                              or DEFAULT_PAGE_TOKENS)
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        self.page_tokens = int(page_tokens)
        self.pages_per_slot = -(-self.max_len // self.page_tokens)  # ceil
        parity = 1 + self.max_streams * self.pages_per_slot
        self.n_pages = parity if n_pages is None else int(n_pages)
        if self.n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (page 0 is scratch), "
                             f"got {self.n_pages}")
        shape = (cfg.n_layers, self.n_pages, self.page_tokens,
                 cfg.n_kv_heads, cfg.head_dim)
        self.k = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=self.dtype, device=self.device)
        # host control state: 0 in the table = unmapped (scratch)
        self.page_table = np.zeros((max_streams, self.pages_per_slot),
                                   np.int32)
        self._free_pages = list(range(self.n_pages - 1, 0, -1))
        self._ref = np.zeros((self.n_pages,), np.int32)
        self._cache: dict = {}            # content key -> page id
        self._lru: OrderedDict = OrderedDict()   # content key -> None
        self.prefix_hits = 0              # pages reused via the cache
        self.prefix_misses = 0            # shareable pages not found
        self._peak_pages = 0

    # ------------------------------------------------------ slot account --
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.max_streams - len(self._free)

    def alloc(self) -> int | None:
        """Claim a free slot (None when the pool is full)."""
        return self._free.pop() if self._free else None

    def free(self, slot: int) -> None:
        """Release a slot.  Raises ``ValueError`` on an out-of-range slot
        or a double free."""
        self._check_owned(slot, "free")
        if self.layout == "paged":
            row = self.page_table[slot]
            for pid in row[row > 0]:
                self._unref(int(pid))
            row[:] = 0
        self.lengths[slot] = 0
        self._free.append(slot)

    def _check_owned(self, slot, what: str) -> None:
        if not isinstance(slot, (int, np.integer)) \
                or not 0 <= slot < self.max_streams:
            raise ValueError(f"{what}: slot {slot!r} out of range "
                             f"[0, {self.max_streams})")
        if slot in self._free:
            raise ValueError(f"{what}: slot {slot} is not allocated "
                             f"(double free, or join before alloc)")

    # ------------------------------------------------------ page account --
    @property
    def pages_in_use(self) -> int:
        """Pages currently referenced (by sessions and/or the prefix
        cache); excludes the scratch page.  0 for the dense layout."""
        return 0 if self.layout == "dense" else int((self._ref > 0).sum())

    @property
    def peak_pages_in_use(self) -> int:
        return 0 if self.layout == "dense" else self._peak_pages

    @property
    def n_free_pages(self) -> int:
        return 0 if self.layout == "dense" else len(self._free_pages)

    def page_bytes(self) -> int:
        """Device bytes of ONE page (both cache sides, all layers)."""
        if self.layout == "dense":
            return 0
        return (2 * self.cfg.n_layers * self.page_tokens
                * self.cfg.n_kv_heads * self.cfg.head_dim
                * self.k.element_size())

    def storage_bytes(self) -> int:
        """Total device bytes of the k+v storage (persistent)."""
        return 2 * self.k.numel() * self.k.element_size()

    def _note_usage(self) -> None:
        used = int((self._ref > 0).sum())
        if used > self._peak_pages:
            self._peak_pages = used

    def _alloc_page(self) -> int:
        if not self._free_pages:
            self._evict()
        if not self._free_pages:
            raise KVPoolExhaustedError(
                f"paged KV pool exhausted: all {self.n_pages - 1} pages "
                f"are referenced by live sessions (size n_pages for the "
                f"working set, or admit fewer concurrent sessions)")
        pid = self._free_pages.pop()
        self._ref[pid] = 1
        obs.event("page_alloc", pid=pid, free=len(self._free_pages))
        return pid

    def _unref(self, pid: int) -> None:
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free_pages.append(pid)

    def _evict(self) -> None:
        """Drop LRU prefix-cache entries whose page only the cache still
        holds, until at least one page is free (or nothing is evictable)."""
        for key in list(self._lru):
            pid = self._cache[key]
            if self._ref[pid] == 1:       # cache is the sole holder
                del self._cache[key]
                del self._lru[key]
                self._unref(pid)
                return
        # every cached page is also live in a session: nothing to evict

    def _register(self, key, pid: int) -> None:
        self._cache[key] = pid
        self._lru[key] = None
        self._ref[pid] += 1               # the cache's own hold
        self._note_usage()

    @staticmethod
    def _full_key(prompt: np.ndarray, bucket: int, j: int, p: int):
        # page j's KV depends on every token <= its last position AND the
        # prefill reduction width (the bucket): key both
        return ("full", int(bucket), j, prompt[:(j + 1) * p].tobytes())

    @staticmethod
    def _rem_key(prompt: np.ndarray, bucket: int, length: int):
        return ("rem", int(bucket), int(length), prompt[:length].tobytes())

    # ------------------------------------------------------- device side --
    def join(self, slot: int, k_new: torch.Tensor, v_new: torch.Tensor,
             length: int, *, prompt: np.ndarray | None = None,
             bucket: int = 0) -> None:
        """Write a session's ``[L, 1, S, KV, H]`` prefill into ``slot``
        and set its valid length.  The writes are issued on the current
        stream AFTER the current step's dispatch, so the stream orders
        them behind any stale in-flight write to this slot.

        Paged layout: allocates the pages covering positions
        ``[0, length]`` (the last one is the session's write page),
        reusing prefix-cache pages for full prompt pages whose content
        key matches (``prompt`` + ``bucket`` enable the lookup), and
        registers fresh prompt pages for future sessions to share.
        """
        self._check_owned(slot, "join")
        if not 1 <= length <= self.max_len:
            raise ValueError(f"join: length {length} outside "
                             f"[1, {self.max_len}]")
        if self.layout == "dense":
            width = k_new.shape[2]
            self.k[:, slot, :width] = k_new[:, 0]
            self.v[:, slot, :width] = v_new[:, 0]
            self.lengths[slot] = length
            return
        p = self.page_tokens
        n_need = min(length // p + 1, self.pages_per_slot)
        n_full = 0 if prompt is None else min(length // p, n_need)
        # Phase 1 — secure every page BEFORE touching the table, cache,
        # or counters.  Cache hits are pinned (ref += 1) the moment they
        # are found: a later _alloc_page may _evict, and eviction takes
        # exactly the cache-sole-holder (ref == 1) pages, which a hit
        # whose donor already left would be.  On exhaustion, unwind the
        # pins/allocations and re-raise — the pool is exactly as it was.
        hit_ids: list = []                # (j, pid, key) shared pages
        new_ids: list = []                # (j, pid, key|None) fresh pages
        try:
            for j in range(n_need):
                if j < n_full:
                    key = self._full_key(prompt, bucket, j, p)
                    pid = self._cache.get(key)
                    if pid is not None:
                        self._ref[pid] += 1        # shared, read-only
                        hit_ids.append((j, pid, key))
                        continue
                    new_ids.append((j, self._alloc_page(), key))
                else:
                    key = None
                    if prompt is not None and j == n_need - 1 \
                            and length % p:
                        key = self._rem_key(prompt, bucket, length)
                    new_ids.append((j, self._alloc_page(), key))
        except KVPoolExhaustedError:
            for _, pid, _ in hit_ids + new_ids:
                self._unref(pid)
            raise
        # Phase 2 — infallible bookkeeping.
        row = self.page_table[slot]
        for pid in row[row > 0]:          # re-join: release any previous
            self._unref(int(pid))         # mapping
        row[:] = 0
        for j, pid, key in hit_ids:
            row[j] = pid
            self._lru.move_to_end(key)
            self.prefix_hits += 1
        if hit_ids:
            obs.event("prefix_hit", slot=slot, pages=len(hit_ids))
        for j, pid, key in new_ids:
            row[j] = pid
            if key is None:
                continue
            if j < n_full:
                self.prefix_misses += 1
                self._register(key, pid)
            elif key not in self._cache:
                # the remainder page: prompt KV at offsets < length%p is
                # append-only (the session decodes at offsets >=
                # length%p), so registering the LIVE page is safe —
                # hitters copy-on-write before touching it.  Never
                # re-register an existing key: overwriting the cache
                # entry would strand the old page's cache reference.
                self._register(key, pid)
        self._note_usage()
        self._scatter_pages(k_new, v_new, [(j, pid) for j, pid, _ in new_ids])
        self.lengths[slot] = length

    def _scatter_pages(self, k_new, v_new, pages) -> None:
        """Write the logical chunks ``j`` of a ``[L, 1, S, KV, H]``
        prefill into their fresh arena pages ``pid`` (``pages``: ``(j,
        pid)`` pairs; shared prefix pages and chunks past the prompt are
        not written)."""
        if not pages:
            return
        p = self.page_tokens
        n_l, _, s, n_kv, h = k_new.shape
        w = self.pages_per_slot * p
        idx = torch.tensor([j for j, _ in pages], device=self.device)
        dst = torch.tensor([pid for _, pid in pages], device=self.device)

        def chunks(x):
            x = torch.nn.functional.pad(x[:, 0], (0, 0, 0, 0, 0, w - s))
            return x.reshape(n_l, self.pages_per_slot, p, n_kv, h)[:, idx]

        self.k[:, dst] = chunks(k_new).to(self.dtype)
        self.v[:, dst] = chunks(v_new).to(self.dtype)

    def join_from_cache(self, slot: int, prompt: np.ndarray, length: int,
                        bucket: int) -> bool:
        """Map ``slot`` entirely from cached prompt pages — the
        full-prompt prefix hit that lets the scheduler SKIP prefill.
        Returns False (mutating nothing) unless every page covering the
        prompt is cached: all full pages by content key, plus the
        remainder page (copied, since this session will write into it).
        Raises :class:`KVPoolExhaustedError` — also mutating nothing —
        when the copy-on-write page cannot be allocated.
        """
        if self.layout == "dense":
            return False
        self._check_owned(slot, "join_from_cache")
        if not 1 <= length <= self.max_len:
            raise ValueError(f"join_from_cache: length {length} outside "
                             f"[1, {self.max_len}]")
        p = self.page_tokens
        n_need = min(length // p + 1, self.pages_per_slot)
        n_full = min(length // p, n_need)
        keys = [self._full_key(prompt, bucket, j, p) for j in range(n_full)]
        rem_key = (self._rem_key(prompt, bucket, length)
                   if length % p and n_full < n_need else None)
        if rem_key is not None:
            keys.append(rem_key)
        if any(k not in self._cache for k in keys):
            return False
        # Pin every cached page BEFORE allocating the write page: the
        # COW _alloc_page may _evict, and eviction takes exactly the
        # cache-sole-holder (ref == 1) pages — with the donor session
        # gone, that includes the very pages this join is mapping.  ref
        # >= 2 makes _evict skip them.  Nothing else is mutated until the
        # allocation succeeds, so an exhaustion error unwinds to the
        # pre-call state.
        pids = [self._cache[k] for k in keys]
        for pid in pids:
            self._ref[pid] += 1
        new_page = None
        if n_need > n_full:                   # the session's write page
            try:
                new_page = self._alloc_page()
            except KVPoolExhaustedError:
                for pid in pids:
                    self._unref(pid)
                raise
        row = self.page_table[slot]
        for pid in row[row > 0]:          # re-join: release any previous
            self._unref(int(pid))         # mapping
        row[:] = 0
        for j in range(n_full):           # the pin doubles as the
            row[j] = pids[j]              # session's own reference
            self._lru.move_to_end(keys[j])
        if rem_key is not None:
            src = pids[-1]                    # copy-on-write: new_page
            self.k[:, new_page] = self.k[:, src]  # is the session's write
            self.v[:, new_page] = self.v[:, src]  # page
            self._unref(src)                  # session holds the copy,
            row[n_full] = new_page            # not the cached original
            self._lru.move_to_end(rem_key)
        elif n_need > n_full:                 # page-aligned prompt: the
            row[n_full] = new_page            # write page starts empty
        self.prefix_hits += len(keys)
        obs.event("prefix_hit", slot=slot, pages=len(keys), full=True)
        self._note_usage()
        self.lengths[slot] = length
        return True

    def advance(self, slots) -> list[int]:
        """The fused step wrote one KV per listed slot: bump lengths (and,
        paged, map the next page when a row crosses a page boundary).

        Returns the (possibly empty) list of slots that crossed a page
        boundary but could NOT get a page — the arena is exhausted for
        THEM, not for the batch, so exhaustion must not raise mid-loop.
        Their lengths stay correct (the step's token was written into the
        still-mapped previous page) and their unmapped entry redirects
        future writes to the scratch page, but their attention would read
        scratch past the boundary — the caller must retire them before
        they decode further."""
        oom: list[int] = []
        for s in slots:
            self.lengths[s] += 1
            if self.layout == "paged":
                j, off = divmod(int(self.lengths[s]), self.page_tokens)
                if off == 0 and j < self.pages_per_slot \
                        and self.page_table[s, j] == 0:
                    try:
                        self.page_table[s, j] = self._alloc_page()
                    except KVPoolExhaustedError:
                        oom.append(int(s))
                        continue
                    self._note_usage()
        return oom

    # ---------------------------------------------------- step operands --
    def step_operands(self) -> tuple:
        """The fused step's cache-state operands, layout-resolved: the
        scheduler dispatches ``step(params, tok, *pool.step_operands())``
        so join/leave and layout never change its call site.  dense:
        ``(k, v, lengths)``; paged: ``(k, v, page_table, lengths)``.

        The host state goes out as COPIES: ``advance``/``free``/``join``
        mutate it while the step is still in flight, and the step reads
        its operands when it runs (JAX saw torn lengths through an alias,
        as nondeterministically duplicated tokens)."""
        if self.layout == "dense":
            return (self.k, self.v, self.lengths.copy())
        return (self.k, self.v, self.page_table.copy(), self.lengths.copy())
