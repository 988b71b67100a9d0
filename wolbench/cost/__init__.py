"""Frozen counts: the card's peaks, the operations and bytes behind each
roofline share and each ``mfu``, and the reduction of a profiler window
to busy time, top device ops and idle gaps.  The program's own counts
are not read."""
