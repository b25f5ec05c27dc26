"""Profile-guided encode autotuning (grid sweep → Pareto frontier →
declared objective).

Sweep the encode-knob grid on a bounded corpus sample, measure each
point's ratio / seek latency / decode throughput through the port's
decoder on the device the archive will live on (`repro_torch.tune.
measure`), keep the Pareto-efficient points, and pick one for a declared
objective:

    prof = autotune(corpus, target="seek").profile     # or "ratio",
    a = encode(corpus, profile=prof)                   # "throughput",
    ga = GenomicArchive.create(corpus, profile=prof)   # or a µs budget

Invalid grid points (e.g. anchor_interval on "ra", a 2 GiB window) are
validated UP FRONT with the encoder's own `validate_encode_params` and
skipped with a logged reason — a sweep never dies mid-grid on a
constraint the encoder would have rejected anyway.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.encoder import encode, validate_encode_params
from repro_torch.tune.measure import measure_point
from repro_torch.tune.profile import EncodeProfile

log = logging.getLogger("repro_torch.tune")

TARGETS = ("seek", "ratio", "throughput")

#: default knob grid: block_size × anchor_interval × entropy; mode is
#: implied (anchor_interval > 0 → "global" checkpointed wavefront,
#: 0 → "ra" self-contained blocks). 64 KiB blocks exercise the implied
#: offset_bytes=4 regime (block-local offsets past the u16 horizon).
DEFAULT_BLOCK_SIZES = (16 * 1024, 64 * 1024)
DEFAULT_ANCHOR_INTERVALS = (0, 4)
DEFAULT_ENTROPIES = ("rans", "raw")


def default_grid(block_sizes: Sequence[int] = DEFAULT_BLOCK_SIZES,
                 anchor_intervals: Sequence[int] = DEFAULT_ANCHOR_INTERVALS,
                 entropies: Sequence[str] = DEFAULT_ENTROPIES) -> List[dict]:
    """The swept knob combinations, as EncodeProfile kwargs."""
    grid = []
    for bs in block_sizes:
        for anc in anchor_intervals:
            for ent in entropies:
                grid.append(dict(block_size=int(bs),
                                 mode="global" if anc else "ra",
                                 entropy=ent, anchor_interval=int(anc)))
    return grid


@dataclasses.dataclass
class TunePoint:
    """One measured grid point (all three objective axes)."""
    profile: EncodeProfile
    ratio: float          # raw / compressed (higher is better)
    seek_us: float        # one-block random access (lower is better)
    decode_GBps: float    # whole-sample decode (higher is better)
    on_frontier: bool = False

    def dominates(self, other: "TunePoint") -> bool:
        ge = (self.ratio >= other.ratio
              and self.seek_us <= other.seek_us
              and self.decode_GBps >= other.decode_GBps)
        gt = (self.ratio > other.ratio
              or self.seek_us < other.seek_us
              or self.decode_GBps > other.decode_GBps)
        return ge and gt


@dataclasses.dataclass
class TuneResult:
    """Sweep output: every measured point, the Pareto frontier, the
    skipped grid points with their rejection reasons, and the profile
    the declared objective selects."""
    profile: EncodeProfile
    target: str
    points: List[TunePoint]
    frontier: List[TunePoint]
    skipped: List[Tuple[dict, str]]
    sample_bytes: int

    def table(self) -> str:
        """The measured frontier as a markdown table."""
        lines = ["| profile | ratio | seek (µs) | decode (GB/s) |",
                 "|---|---|---|---|"]
        for p in sorted(self.frontier, key=lambda p: p.seek_us):
            lines.append(f"| `{p.profile.describe()}` | {p.ratio:.2f} | "
                         f"{p.seek_us:.0f} | {p.decode_GBps:.3f} |")
        return "\n".join(lines)


def pareto_frontier(points: List[TunePoint]) -> List[TunePoint]:
    """Non-dominated subset over (ratio ↑, seek_us ↓, decode_GBps ↑)."""
    front = [p for p in points
             if not any(q.dominates(p) for q in points if q is not p)]
    for p in points:
        p.on_frontier = p in front
    return front


def validate_grid(grid: Sequence[dict], raw_size: int
                  ) -> Tuple[List[dict], List[Tuple[dict, str]]]:
    """Split a knob grid into (valid, [(point, reason)]) up front, using
    the encoder's own constraint checks — a skipped point is logged, a
    valid one is guaranteed not to raise on knob validation mid-sweep."""
    valid, skipped = [], []
    for pt in grid:
        try:
            validate_encode_params(
                pt.get("block_size", 1), pt.get("mode", "ra"),
                pt.get("entropy", "rans"), pt.get("anchor_interval", 0),
                raw_size=raw_size)
        except ValueError as e:
            reason = str(e)
            log.info("tune: skipping grid point %s: %s", pt, reason)
            skipped.append((pt, reason))
            continue
        valid.append(pt)
    return valid, skipped


def _select(front: List[TunePoint], target: str,
            latency_budget_us: Optional[float]) -> TunePoint:
    if latency_budget_us is not None:
        within = [p for p in front if p.seek_us <= latency_budget_us]
        if within:
            # best ratio that still meets the seek budget
            return max(within, key=lambda p: p.ratio)
        log.info("tune: no frontier point meets seek budget %.0fus; "
                 "falling back to the fastest seek", latency_budget_us)
        return min(front, key=lambda p: p.seek_us)
    if target == "seek":
        return min(front, key=lambda p: p.seek_us)
    if target == "ratio":
        return max(front, key=lambda p: p.ratio)
    if target == "throughput":
        return max(front, key=lambda p: p.decode_GBps)
    raise ValueError(f"unknown tune target {target!r} "
                     f"(have {TARGETS}, or pass latency_budget_us)")


def autotune(data: bytes, target: str = "seek",
             latency_budget_us: Optional[float] = None,
             grid: Optional[Sequence[dict]] = None,
             sample_bytes: int = 1 << 20, iters: int = 2,
             device="cuda") -> TuneResult:
    """Sweep the encode-knob grid on a bounded sample of `data` and return
    the profile a declared objective selects.

    `target` is one of "seek" (minimize point-read latency), "ratio"
    (maximize compression), "throughput" (maximize full decode), or pass
    `latency_budget_us` to get the best ratio whose measured seek latency
    fits the budget. The sweep measures at most `sample_bytes` of the
    corpus — tuning cost is bounded regardless of archive size. Every
    point decodes on `device` (default the card; "cpu" runs the plain
    PyTorch versions of the kernels).
    """
    from repro_torch.core.decoder import Decoder
    if target not in TARGETS and latency_budget_us is None:
        raise ValueError(f"unknown tune target {target!r} "
                         f"(have {TARGETS}, or pass latency_budget_us)")
    data = bytes(data[:sample_bytes]) if len(data) > sample_bytes \
        else bytes(data)
    if not data:
        raise ValueError("cannot tune on an empty corpus sample")
    valid, skipped = validate_grid(grid if grid is not None
                                   else default_grid(), len(data))
    if not valid:
        raise ValueError(
            f"every grid point was invalid for a {len(data)}-byte sample: "
            + "; ".join(r for _, r in skipped))
    points: List[TunePoint] = []
    for pt in valid:
        prof = EncodeProfile(**pt)
        a = encode(data, profile=prof)
        dec = Decoder(a, device=device)
        m = measure_point(a, dec, len(data), iters=iters)
        points.append(TunePoint(profile=prof, **m))
        log.info("tune: %s ratio=%.2f seek=%.0fus decode=%.3fGB/s",
                 prof.describe(), m["ratio"], m["seek_us"],
                 m["decode_GBps"])
    front = pareto_frontier(points)
    best = _select(front, target, latency_budget_us)
    return TuneResult(profile=best.profile, target=target, points=points,
                      frontier=front, skipped=skipped,
                      sample_bytes=len(data))
