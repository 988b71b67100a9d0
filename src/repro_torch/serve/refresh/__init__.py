"""Zero-downtime online index refresh (counterpart of
``repro.serve.refresh``).

The LSS hash is *trained* (paper §3.3) — a serving system that never
re-learns it serves a stale index.  :class:`IndexRefresher` re-runs IUL
epochs on a snapshot of the calibration set off the hot path, then swaps
the candidate index into the Engine through the versioned epoch table
(``Engine.swap_index``) with a guarded probation window and automatic
rollback.
"""

from repro_torch.serve.refresh.refresher import IndexRefresher, RefreshConfig

__all__ = ["IndexRefresher", "RefreshConfig"]
