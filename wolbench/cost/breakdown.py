"""Where a profiled window's time went, from its raw records (frozen from
the port's smoke script's ``window_breakdown``): the window is the first
record to the last, the device's busy time is the union of its ops'
intervals, device ops are summed by name, host ops by self time (an op's
time less that of the ops it encloses on its thread).  Added here: the
device's idle gaps, each named after the innermost host op that holds
its midpoint on any thread (``idle`` where none does).

A record is ``(on_device, name, t0_ns, t1_ns, thread)``.
"""

from __future__ import annotations

__all__ = ["reduce_window"]

TOP = 10


def _union(spans: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for t0, t1 in sorted(spans):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def _host_self(host: dict) -> dict[str, int]:
    self_ns: dict[str, int] = {}
    for ops in host.values():
        stack: list[list] = []                  # [end, name, self ns]
        for t0, t1, name in sorted(ops, key=lambda o: (o[0], -o[1])):
            while stack and stack[-1][0] <= t0:
                _, n, s = stack.pop()
                self_ns[n] = self_ns.get(n, 0) + s
            if stack:
                stack[-1][2] -= min(t1, stack[-1][0]) - t0
            stack.append([t1, name, t1 - t0])
        for _, n, s in stack:
            self_ns[n] = self_ns.get(n, 0) + s
    return self_ns


def _gap_owners(mids: list[int], host_ops: list[tuple[int, int, str]]
                ) -> list[str]:
    """For each midpoint (ascending), the shortest host op holding it:
    one sweep over the ops sorted by start."""
    owners, active, j = [], [], 0
    for mid in mids:
        while j < len(host_ops) and host_ops[j][0] <= mid:
            active.append(host_ops[j])
            j += 1
        active = [op for op in active if op[1] > mid]
        best = min(active, key=lambda op: op[1] - op[0], default=None)
        owners.append("idle" if best is None else best[2])
    return owners


def reduce_window(records: list[tuple[bool, str, int, int, int]],
                  top: int = TOP) -> dict:
    """``window_s``, ``busy_s``, ``device_ops`` and ``idle_gaps`` (each
    ``[[name, seconds], ...]``, largest first, at most ``top``),
    ``host_self`` (the same for host ops by self time), ``device_ns`` (the
    summed device time by name) and ``device_count`` (ops by name)."""
    dev_ns: dict[str, int] = {}
    dev_n: dict[str, int] = {}
    spans: list[tuple[int, int]] = []
    host: dict[int, list] = {}
    lo, hi = None, None
    for on_device, name, t0, t1, thread in records:
        if on_device:
            dev_ns[name] = dev_ns.get(name, 0) + t1 - t0
            dev_n[name] = dev_n.get(name, 0) + 1
            spans.append((t0, t1))
        else:
            host.setdefault(thread, []).append((t0, t1, name))
        lo = t0 if lo is None else min(lo, t0)
        hi = t1 if hi is None else max(hi, t1)
    if lo is None:
        return {"window_s": 0.0, "busy_s": 0.0, "device_ops": [],
                "idle_gaps": [], "host_self": [], "device_ns": {},
                "device_count": {}}
    busy = _union(spans)
    gaps, prev = [], lo
    for t0, t1 in busy:
        if t0 > prev:
            gaps.append((prev, t0))
        prev = max(prev, t1)
    if hi > prev:
        gaps.append((prev, hi))
    host_ops = sorted(op for ops in host.values() for op in ops)
    gap_ns: dict[str, int] = {}
    owners = _gap_owners([(g0 + g1) // 2 for g0, g1 in gaps], host_ops)
    for (g0, g1), owner in zip(gaps, owners):
        gap_ns[owner] = gap_ns.get(owner, 0) + g1 - g0
    self_ns = _host_self(host)

    def ranked(d: dict[str, int]) -> list:
        return [[n[:120], d[n] / 1e9]
                for n in sorted(d, key=d.get, reverse=True)[:top]]

    return {"window_s": (hi - lo) / 1e9,
            "busy_s": sum(t1 - t0 for t0, t1 in busy) / 1e9,
            "device_ops": ranked(dev_ns), "idle_gaps": ranked(gap_ns),
            "host_self": ranked(self_ns), "device_ns": dev_ns,
            "device_count": dev_n}
