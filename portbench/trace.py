"""Host spans the harness opens around its calls into the program, and the
reduction of a torch.profiler trace of the window to device intervals.

Spans are (name, start, end) in time.time_ns(), the clock that the
profiler's events carry, so a device gap can be labelled with the span
open on the host at the time.  A span is recorded in every run (a list
append); only a run with --trace 1 profiles the device.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]


class Spans:
    """Host spans of one run, kept in memory."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))

    def total_s(self, name: str, lo: int = 0, hi: int = 1 << 63) -> float:
        """Seconds inside spans of `name` that lie within [lo, hi]."""
        return sum(max(0, min(b, hi) - max(a, lo))
                   for n, a, b in self.items if n == name) / 1e9

    def open_at(self, t: int) -> Optional[str]:
        """The innermost span open at time t (the latest started)."""
        best = None
        for n, a, b in self.items:
            if a <= t < b and (best is None or a > best[1]):
                best = (n, a)
        return best[0] if best else None


class SpanMapper:
    """The mapper as the program's driver sees it, with each map_reads
    call recorded as a span (the rest is the mapper's own)."""

    def __init__(self, mapper, spans: Spans):
        self._mapper = mapper
        self._spans = spans

    def map_reads(self, *args, **kwargs):
        with self._spans.span("map_reads"):
            return self._mapper.map_reads(*args, **kwargs)

    def __getattr__(self, attr):
        return getattr(self._mapper, attr)


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class DeviceTrace:
    """The device operations of a profiled window, per card: (name, start,
    end) in ns, clipped to the window [t0, t1]."""

    def __init__(self, ops: Dict[int, List[Tuple[str, int, int]]],
                 t0: int, t1: int):
        self.ops = ops
        self.t0, self.t1 = t0, t1

    @classmethod
    def from_profiler(cls, prof, t0: int, t1: int) -> "DeviceTrace":
        ops: Dict[int, List[Tuple[str, int, int]]] = {}
        for e in prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            a = e.start_ns()
            b = a + e.duration_ns()
            a, b = max(a, t0), min(b, t1)
            if b > a:
                ops.setdefault(int(e.device_index()), []).append(
                    (e.name(), a, b))
        return cls(ops, t0, t1)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self, card: int) -> float:
        return sum(b - a for a, b in union(
            [(a, b) for _, a, b in self.ops.get(card, [])])) / 1e9

    def op_seconds(self, match: str = "") -> float:
        """Summed seconds of the operations whose name contains `match`."""
        return sum(b - a for evs in self.ops.values()
                   for n, a, b in evs if match in n) / 1e9

    def op_count(self, match: str) -> int:
        return sum(1 for evs in self.ops.values() for n, _, _ in evs
                   if match in n)

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, int] = {}
        for evs in self.ops.values():
            for name, a, b in evs:
                tot[name] = tot.get(name, 0) + (b - a)
        return [[k[:200], v / 1e9] for k, v in sorted(
            tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, card: int) -> List[Interval]:
        busy = union([(a, b) for _, a, b in self.ops.get(card, [])])
        gaps, t = [], self.t0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        return gaps

    def labelled_gaps(self, spans: Spans, card: int = 0,
                      n: int = 10) -> List[List]:
        """The longest idle gaps of a card, each named by the host span
        open at its middle ('none' where no span was open)."""
        gaps = sorted(self.idle_gaps(card), key=lambda g: g[0] - g[1])[:n]
        return [[spans.open_at((a + b) // 2) or "none", (b - a) / 1e9]
                for a, b in gaps]
