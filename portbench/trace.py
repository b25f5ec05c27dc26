"""The device trace of a traced window, reduced to what readers need.

The harness opens `torch.profiler` for the last part of a `--trace 1`
run's window and marks it, and each of its own steps, with
`record_function` spans: `traced_window` around the whole, and
`client` (make the next request), `plan_and_call` (the entry call),
`wait` (wait for the oldest request in flight) and `check` (keep the
request or drop it). The device operations inside `traced_window` give
the busy time (the union of their intervals), and each idle gap between
them is named by the harness span the host was in at its middle.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, List, Tuple

SPANS = ("client", "plan_and_call", "wait", "check")
WINDOW = "traced_window"

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Merged, sorted, non-overlapping cover of `intervals`."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


@dataclasses.dataclass
class Trace:
    """Device operations and harness spans of one traced window, times in
    microseconds on the profiler's clock."""
    ops: List[Tuple[str, float, float]]       # device operations
    spans: List[Tuple[str, float, float]]     # harness spans
    window: Interval

    def __post_init__(self):
        lo, hi = self.window
        self.busy = union(clip(((a, b) for _, a, b in self.ops), lo, hi))
        self.spans = sorted(self.spans, key=lambda s: s[1])
        self._span_starts = [a for _, a, _ in self.spans]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def kernel(self, name: str) -> Tuple[int, float]:
        """(launches, device seconds) of the operations whose name holds
        `name`, inside the window."""
        lo, hi = self.window
        hits = [(a, b) for n, a, b in self.ops
                if name in n and b > lo and a < hi]
        return len(hits), sum(min(b, hi) - max(a, lo) for a, b in hits) / 1e6

    def gaps(self) -> List[Interval]:
        """Idle intervals of the device inside the window."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy for x in iv] + [hi]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def span_at(self, t: float) -> str:
        """The harness span open at time `t`, else "other" (the harness's
        spans follow one another and do not nest)."""
        i = bisect.bisect_right(self._span_starts, t) - 1
        if i >= 0 and t < self.spans[i][2]:
            return self.spans[i][0]
        return "other"

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds summed by the harness span the host was in."""
        out: Dict[str, float] = {}
        for a, b in self.gaps():
            n = self.span_at((a + b) / 2)
            out[n] = out.get(n, 0.0) + (b - a) / 1e6
        return out

    def top_ops(self, n: int = 10) -> List[list]:
        lo, hi = self.window
        tot: Dict[str, float] = {}
        for name, a, b in self.ops:
            if b > lo and a < hi:
                key = name[:96]
                tot[key] = tot.get(key, 0.0) + (min(b, hi) - max(a, lo)) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]

    def breakdown(self) -> dict:
        idle = sorted(self.idle_by_span().items(), key=lambda kv: -kv[1])
        return {"device_ops": self.top_ops(10),
                "idle_gaps": [[k, v] for k, v in idle[:10]]}


def from_profiler(prof) -> Trace:
    """Reduce a stopped `torch.profiler.profile` to a `Trace`."""
    from torch.autograd import DeviceType
    ops, spans, window = [], [], None
    marks = set(SPANS) | {WINDOW}
    for e in prof.events():
        t0, t1 = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CPU:
            if e.name == WINDOW:
                window = (t0, t1)
            elif e.name in SPANS:
                spans.append((e.name, t0, t1))
        elif e.name not in marks:
            ops.append((e.name, t0, t1))
    if window is None:
        raise RuntimeError("the trace holds no traced_window span")
    return Trace(ops=ops, spans=spans, window=window)
