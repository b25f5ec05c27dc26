"""The program's own spans in a traced window, for per-layer readers.

While a profiler records, the program (`repro_torch.obs`) opens a span at
each stage of a request: `fetch_block_range` (the entry call), `plan`,
`execute`, `upload`, `cover_sync`, `entropy`, `match`, `gather`,
`verify`. They are function-scope profiler ranges with no device-side
mirror, so `portbench.trace.Trace`, which keeps the device operations and
the harness's own spans, is the same with them or without them. The
program also keeps each span's host interval (`obs.SPAN_LOG`, on
`time.perf_counter`); this module takes the spans of the traced requests'
entry calls from there. The readers use their host times alone. The
split of the device's idle time by span puts them on the profiler's
clock by the harness's `plan_and_call` spans, which open and close
around the same calls, then moves each request onto the device's
timestamps by its covering-set read back (the two drift apart within a
window). A program without `repro_torch.obs` gives no spans, and every
reader built on them reads nothing.

    PYTHONPATH=src python3 -m portbench.program_spans --workload <cell>
        --seed <n> --seconds <s>

from the root of a checkout runs one traced window of a cell on the
card, as `portbench/run.py --trace 1` does, and prints one JSON object:
the host time of each span per request; the share of the entry span
that its child spans cover; the device's idle time by the innermost
program span open at each gap's middle, and the largest gaps; the share
of the card's synchronous copies that fall inside the span that waits
for them, and their lag by quarter of the window (which check the two
clocks against each other); the gather's
device time; the first requests' spans and device operations; the mean
entry call of the traced and the untraced requests; and the cell's
per-layer metrics.
"""
from __future__ import annotations

import bisect
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from portbench.trace import union

ROOT = Path(__file__).resolve().parents[1]
ENTRY = "fetch_block_range"
PREFIX = "repro_torch."
Span = Tuple[str, float, float]


def host_spans(ctx) -> List[Span]:
    """(name, start, end) on the host clock, in seconds, of the program's
    spans inside the traced requests' entry calls; [] where the program
    keeps no spans."""
    try:
        from repro_torch import obs
    except ImportError:
        return []
    reqs = ctx.traced()
    if not reqs:
        return []
    lo, hi = reqs[0].t_issue, reqs[-1].t_return
    return sorted((s for s in obs.SPAN_LOG if s[1] >= lo and s[2] <= hi),
                  key=lambda s: s[1])


def covered_s(spans: Iterable[Span], names) -> float:
    """Seconds of the union of the spans named in `names`."""
    return sum(b - a for a, b in union((a, b) for n, a, b in spans
                                       if n in names))


def per_request_ms(ctx, names) -> Optional[float]:
    """Host milliseconds a request spends inside the spans named in
    `names` (their union: a span nested in another of them counts once),
    over the entry spans of the traced window; None without them."""
    spans = host_spans(ctx)
    n = sum(1 for s in spans if s[0] == ENTRY)
    if not n:
        return None
    return covered_s(spans, set(names)) / n * 1e3


def on_profiler_clock(ctx, spans: List[Span]) -> Optional[List[Span]]:
    """`spans` moved to the profiler's clock (microseconds) by the median
    offset between each traced request's `plan_and_call` span and its
    issue time; None where the two do not pair up one to one."""
    calls = [s for s in ctx.trace.spans if s[0] == "plan_and_call"]
    reqs = ctx.traced()
    if not calls or len(calls) != len(reqs):
        return None
    off = statistics.median(c[1] - r.t_issue * 1e6
                            for c, r in zip(calls, reqs))
    return [(n, a * 1e6 + off, b * 1e6 + off) for n, a, b in spans]


def on_device_clock(trace, spans: List[Span]) -> List[Span]:
    """`spans` (on the profiler's clock) moved, one request at a time, so
    that each `cover_sync` span ends where the device-to-host copy it
    waits for ends: the host's and the device's timestamps drift apart
    by up to some ms over a traced window, and the covering set's size
    read back is one point that both clocks see, once a request. A
    request with no such copy within 4 ms keeps the last shift found."""
    copies = sorted(b for n, a, b in trace.ops
                    if n.startswith("Memcpy DtoH"))
    spans = sorted(spans, key=lambda s: s[1])
    out, shift, entry_end = [], 0.0, None
    for k, (n, a, b) in enumerate(spans):
        if n == ENTRY:
            entry_end = b
            ends = [e for m, _, e in spans[k:] if m == "cover_sync"
                    and e <= entry_end][:1]
            if ends and copies:
                i = bisect.bisect_left(copies, ends[0])
                near = min((copies[j] for j in (i - 1, i)
                            if 0 <= j < len(copies)),
                           key=lambda c: abs(c - ends[0]))
                if abs(near - ends[0]) < 4000:
                    shift = near - ends[0]
        out.append((n, a + shift, b + shift))
    return out


def named_gaps(trace, spans: List[Span]) -> List[Span]:
    """(name, start, end) of each idle gap of the device in the traced
    window, named by the innermost program span open at its middle
    (`repro_torch.<name>`), else by the harness span (`Trace.span_at`).
    `spans` are on the profiler's clock and nest inside their entry
    spans."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [a for _, a, _ in spans]
    entries = [(a, b) for n, a, b in spans if n == ENTRY]
    entry_starts = [a for a, _ in entries]
    out = []
    for a, b in trace.gaps():
        m = (a + b) / 2
        name = trace.span_at(m)
        j = bisect.bisect_right(entry_starts, m) - 1
        if j >= 0 and m < entries[j][1]:
            # the latest-starting span still open at m is the innermost
            i = bisect.bisect_right(starts, m) - 1
            while i >= 0 and spans[i][1] >= entries[j][0]:
                if spans[i][2] > m:
                    name = PREFIX + spans[i][0]
                    break
                i -= 1
        out.append((name, a, b))
    return out


def idle_by_program_span(trace, spans: List[Span]) -> Dict[str, float]:
    """Idle seconds of the device in the traced window, summed by the
    names `named_gaps` gives the gaps."""
    out: Dict[str, float] = {}
    for name, a, b in named_gaps(trace, spans):
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


def gather_device_s(trace) -> float:
    """Device seconds of the gather in the traced window: the operations
    that follow each request's `lz77_match_kernel` on the stream, up to
    the next host-to-device copy, which opens the next request."""
    lo, hi = trace.window
    total, open_ = 0.0, False
    for name, a, b in sorted(trace.ops, key=lambda o: o[1]):
        if "lz77_match_kernel" in name:
            open_ = True
        elif name.startswith("Memcpy HtoD"):
            open_ = False
        elif open_ and b > lo and a < hi:
            total += (min(b, hi) - max(a, lo)) / 1e6
    return total


# ------------------------------------------------------------- the window
def _copies_inside(trace, spans: List[Span]) -> dict:
    """Share of the card's synchronous copies that lie inside the program
    span that waits for them, on the profiler's clock (within 25 us): a
    pageable host-to-device copy inside an `upload` span, a
    device-to-host copy inside a `cover_sync` span. Near 1 where the
    program's spans and the device trace share one clock."""
    out = {}
    for op, stage in (("Memcpy HtoD", "upload"), ("Memcpy DtoH",
                                                  "cover_sync")):
        ivs = union((a - 25, b + 25) for n, a, b in spans if n == stage)
        starts = [a for a, _ in ivs]
        copies = [(a, b) for n, a, b in trace.ops if n.startswith(op)]
        inside = 0
        for a, b in copies:
            i = bisect.bisect_right(starts, a) - 1
            inside += i >= 0 and b <= ivs[i][1]
        if copies:
            out[stage] = inside / len(copies)
    return out


def _copy_lag(trace, spans: List[Span]) -> List[list]:
    """For each quarter of the traced window, the quartiles of each
    pageable host-to-device copy's end less the end of the nearest
    `upload` span, in us: the host returns from a synchronous copy just
    after the card finishes it, so a lag that is steady and small says
    the two clocks agree, and one that moves says they drift."""
    ends = sorted(b for n, a, b in spans if n == "upload")
    lo, hi = trace.window
    quarters = [[] for _ in range(4)]
    for name, a, b in trace.ops:
        if name.startswith("Memcpy HtoD") and ends and lo <= b < hi:
            i = bisect.bisect_left(ends, b)
            near = min((ends[j] for j in (i - 1, i) if 0 <= j < len(ends)),
                       key=lambda e: abs(e - b))
            quarters[int(4 * (b - lo) / (hi - lo))].append(b - near)
    return [statistics.quantiles(q, n=4) if len(q) >= 4 else q
            for q in quarters]


def _diagnose(ctx) -> dict:
    from portbench import harness
    spans = host_spans(ctx)
    entries = [s for s in spans if s[0] == ENTRY]
    n = len(entries)
    names = sorted({s[0] for s in spans})
    out = {"entry_spans": n, "spans_per_request": len(spans) / n if n else 0,
           "host_ms_per_request": {k: covered_s(spans, {k}) / n * 1e3
                                   for k in names} if n else {}}
    if n:
        entry_s = covered_s(spans, {ENTRY})
        kids = [s for s in spans if s[0] in ("plan", "execute")]
        out["child_cover_of_entry"] = covered_s(kids, {"plan", "execute"}) \
            / entry_s
        stages = {"plan", "upload", "cover_sync", "entropy", "match",
                  "gather", "verify"}
        out["stage_cover_of_entry"] = covered_s(spans, stages) / entry_s
        moved = on_profiler_clock(ctx, spans)
        if moved is not None:
            moved = on_device_clock(ctx.trace, moved)
            split = idle_by_program_span(ctx.trace, moved)
            out["idle_by_program_span"] = dict(
                sorted(split.items(), key=lambda kv: -kv[1]))
            out["copies_inside_their_span"] = _copies_inside(ctx.trace,
                                                             moved)
            out["copy_lag_us_by_quarter"] = _copy_lag(ctx.trace, moved)
            gaps = sorted(named_gaps(ctx.trace, moved),
                          key=lambda g: g[1] - g[2])
            out["largest_gaps_us"] = [(nm, a, b - a) for nm, a, b in
                                      gaps[:12]]
            lo = moved[0][1]
            hi = sorted(s[2] for s in moved if s[0] == ENTRY)[min(3, n - 1)]
            out["timeline"] = {
                "spans": [(nm, a - lo, b - lo) for nm, a, b in moved
                          if a < hi],
                "ops": [(nm[:40], a - lo, b - lo) for nm, a, b in
                        sorted(ctx.trace.ops, key=lambda o: o[1])
                        if lo - 2000 < a < hi + 8000]}
        out["gather_device_ms"] = gather_device_s(ctx.trace) / n * 1e3
    out["gather_device_s"] = gather_device_s(ctx.trace)
    out["top_ops"] = ctx.trace.top_ops(16)
    out["idle_by_span"] = ctx.trace.idle_by_span()
    out["busy_s"], out["window_s"] = ctx.trace.busy_s, ctx.trace.window_s
    for part, reqs in (("traced", ctx.traced()),
                       ("untraced", ctx.untraced())):
        out[f"entry_call_ms_{part}"] = (
            sum(r.t_return - r.t_issue for r in reqs) / len(reqs) * 1e3
            if reqs else None)
    out["per_layer"] = harness.read_metrics(ROOT, ctx.cell.per_layer, ctx)
    return out


def main(argv=None) -> int:
    import argparse
    from portbench import harness
    p = argparse.ArgumentParser(description="one traced window, split by "
                                            "the program's spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    cell = harness.load_cell(ROOT, args.workload)
    worker = harness.HostSetup(ROOT, cell.config, args.seed)
    try:
        import torch
        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 2
        torch.zeros(1, device="cuda").sum().item()
        host = worker.result(timeout=harness.HOST_SETUP_TIMEOUT_S)
    finally:
        worker.stop()
    t = time.perf_counter()
    sess = harness.prepare(cell, args.seed, host, device="cuda")
    harness.warm(sess)
    harness.warm_profiler(sess)
    win = harness.run_window(sess, args.seconds, trace=True)
    ctx = harness.Context(cell=cell, setup_s=win.t0 - t, window=win,
                          session=sess)
    out = _diagnose(ctx)
    out["device"] = harness.device_info(sess.device, cell.chips,
                                        win.memory_peak_bytes)
    win.kept[:] = [(r, spec, harness._host(o)) for r, spec, o in win.kept]
    harness.release(sess)
    checks, _ = harness.check(sess, win)
    out["correct"] = harness.correct(checks, len(win.kept), win.missing)
    out["checks"] = checks
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
