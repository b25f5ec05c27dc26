"""Closed-loop traffic harness for the multi-tenant serving plane.

Workload generators (Zipfian point-reads, flash-crowd hot-key shifts,
scan-heavy mixes) drive a `ServingFrontend` closed-loop — each tenant
keeps a fixed number of requests outstanding, so offered load tracks the
measured service rate instead of an open-loop arrival fantasy — and the
run reports what a serving plane's users feel: p50/p95/p99 latency,
goodput, deadline-miss rate, typed `Overloaded` rejections, and
per-tenant cache hit rates. A sample of the
served payloads is spot-checked bit-identical against a direct
`fetch_reads` every run, so the serving plane can never drift from the
decode plane silently.

    python -m repro_torch.serving.traffic --smoke [--device cpu]
        # tiny closed loop on the CUDA card (default); asserts zero misses
        # at trivial load
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.frontend import Overloaded, Result, ServingFrontend  # noqa: F401


# ---------------------------------------------------------------- samplers
class ZipfianSampler:
    """Zipfian point-reads over `n_keys` read ids (rank r drawn with
    probability ∝ 1/r^s). `drift_every` > 0 rolls the rank→key map by
    `n_keys // 4` every that many draws — a slowly wandering hot head,
    the regime where admission without aging pins yesterday's keys."""

    def __init__(self, n_keys: int, s: float = 1.1, seed: int = 0,
                 drift_every: Optional[int] = None):
        self.n_keys = int(n_keys)
        self.rng = np.random.default_rng(seed)
        p = 1.0 / np.arange(1, self.n_keys + 1) ** float(s)
        self.p = p / p.sum()
        self.perm = self.rng.permutation(self.n_keys)
        self.drift_every = drift_every
        self.draws = 0

    def draw(self, k: int) -> List[int]:
        ranks = self.rng.choice(self.n_keys, size=k, p=self.p)
        out = self.perm[ranks]
        self.draws += k
        if self.drift_every and self.draws >= self.drift_every:
            self.perm = np.roll(self.perm, self.n_keys // 4)
            self.draws = 0
        return [int(i) for i in out]


class FlashCrowdSampler:
    """Zipfian base traffic until `shift_at` draws, then a flash crowd:
    `hot_frac` of every subsequent draw lands uniformly on `hot_n` keys
    from the cold tail of the original distribution — the sudden hot-key
    shift that stale frequency counters veto and TinyLFU admits."""

    def __init__(self, n_keys: int, s: float = 1.1, seed: int = 0,
                 shift_at: int = 256, hot_n: int = 8,
                 hot_frac: float = 0.9):
        self.base = ZipfianSampler(n_keys, s=s, seed=seed)
        self.rng = np.random.default_rng(seed + 1)
        self.shift_at = int(shift_at)
        self.hot = self.base.perm[-int(hot_n):]   # coldest ranks pre-shift
        self.hot_frac = float(hot_frac)
        self.drawn = 0

    def draw(self, k: int) -> List[int]:
        self.drawn += k
        if self.drawn <= self.shift_at:
            return self.base.draw(k)
        crowd = self.rng.random(k) < self.hot_frac
        ids = np.asarray(self.base.draw(k))
        ids[crowd] = self.rng.choice(self.hot, size=int(crowd.sum()))
        return [int(i) for i in ids]


class ScanSampler:
    """Scan-heavy traffic: block-aligned byte-range slices of
    `span_bytes`, walking the archive sequentially with random restarts
    (StreamingExecutor-shaped load on the point-read plane)."""

    def __init__(self, raw_size: int, span_bytes: int = 1 << 15,
                 seed: int = 0, restart_p: float = 0.1):
        self.raw_size = int(raw_size)
        self.span = min(int(span_bytes), self.raw_size)
        self.rng = np.random.default_rng(seed)
        self.restart_p = float(restart_p)
        self.pos = 0

    def draw(self, k: int) -> List[slice]:
        out = []
        for _ in range(k):
            if self.pos + self.span > self.raw_size or \
                    self.rng.random() < self.restart_p:
                self.pos = int(self.rng.integers(
                    0, max(1, self.raw_size - self.span)))
            out.append(slice(self.pos, self.pos + self.span))
            self.pos += self.span
        return out


class MixSampler:
    """Weighted mixture of samplers (e.g. 70% Zipfian points + 30%
    scans)."""

    def __init__(self, samplers: Sequence, weights: Sequence[float],
                 seed: int = 0):
        if len(samplers) != len(weights) or not samplers:
            raise ValueError("samplers and weights must pair up")
        self.samplers = list(samplers)
        w = np.asarray(weights, float)
        self.w = w / w.sum()
        self.rng = np.random.default_rng(seed)

    def draw(self, k: int) -> list:
        picks = self.rng.choice(len(self.samplers), size=k, p=self.w)
        out = []
        for i in picks:
            out.extend(self.samplers[i].draw(1))
        return out


# ------------------------------------------------------------ closed loop
@dataclasses.dataclass
class TenantLoad:
    """One tenant's closed-loop spec: its sampler, how many requests it
    keeps outstanding, its deadline budget and priority band, and how
    many requests it issues in total."""
    name: str
    sampler: object
    requests: int = 200
    concurrency: int = 8
    deadline_us: Optional[float] = None
    priority: Optional[int] = None


def _percentiles(lat_us: List[float]) -> Dict[str, float]:
    if not lat_us:
        return {"p50_us": 0.0, "p95_us": 0.0, "p99_us": 0.0}
    p50, p95, p99 = np.percentile(np.asarray(lat_us), [50, 95, 99])
    return {"p50_us": float(p50), "p95_us": float(p95),
            "p99_us": float(p99)}


def run_closed_loop(frontend: ServingFrontend, loads: Sequence[TenantLoad],
                    verify_sample: int = 8, max_cycles: int = 100_000
                    ) -> dict:
    """Drive the frontend closed-loop until every tenant has issued its
    request quota and the queues are drained. An `Overloaded` submit
    resolves that request immediately (the client saw the rejection);
    everything else completes through scheduler cycles. After the run,
    `verify_sample` point-reads per tenant are spot-checked bit-identical
    against a direct `store.fetch_reads` (0 disables). Returns the report
    dict (aggregate + per-tenant latency percentiles, goodput,
    deadline-miss rate, rejects/sheds, cache hit rates)."""
    state = {ld.name: {"issued": 0, "outstanding": 0, "lat": [],
                       "ok": 0, "late": 0, "shed": 0, "rejected": 0}
             for ld in loads}
    t_start = frontend.clock()
    for _ in range(max_cycles):
        live = False
        for ld in loads:
            st = state[ld.name]
            # one batched draw per tenant per cycle: the sampler runs
            # once, not per-request, so harness overhead between another
            # tenant's submit timestamp and the dispatch stays O(1)
            need = min(ld.requests - st["issued"],
                       ld.concurrency - st["outstanding"])
            for addr in (ld.sampler.draw(need) if need > 0 else ()):
                st["issued"] += 1
                r = frontend.submit(ld.name, addr,
                                    deadline_us=ld.deadline_us,
                                    priority=ld.priority)
                if isinstance(r, Overloaded):
                    st["rejected"] += 1
                else:
                    st["outstanding"] += 1
            live = live or st["issued"] < ld.requests or st["outstanding"]
        if not live:
            break
        frontend.step()
        for res in frontend.take_results().values():
            st = state[res.tenant]
            st["outstanding"] -= 1
            if res.status == "shed":
                st["shed"] += 1
                continue
            st["lat"].append(res.latency_us)
            st[res.status if res.status == "late" else "ok"] += 1
    elapsed = max(frontend.clock() - t_start, 1e-9)

    fe_stats = frontend.stats()
    tenants = {}
    all_lat: List[float] = []
    tot_ok = tot_late = tot_shed = tot_rej = 0
    for ld in loads:
        st = state[ld.name]
        attempts = st["ok"] + st["late"] + st["shed"] + st["rejected"]
        misses = st["late"] + st["shed"] + st["rejected"]
        tenants[ld.name] = {
            **_percentiles(st["lat"]),
            "issued": st["issued"], "ok": st["ok"], "late": st["late"],
            "shed": st["shed"], "rejected": st["rejected"],
            "deadline_miss_rate": misses / attempts if attempts else 0.0,
            "cache_hit_rate":
                fe_stats["tenants"][ld.name]["cache_hit_rate"],
        }
        all_lat.extend(st["lat"])
        tot_ok += st["ok"]
        tot_late += st["late"]
        tot_shed += st["shed"]
        tot_rej += st["rejected"]
    attempts = tot_ok + tot_late + tot_shed + tot_rej
    report = {
        "aggregate": {
            **_percentiles(all_lat),
            "ok": tot_ok, "late": tot_late, "shed": tot_shed,
            "rejected": tot_rej,
            "deadline_miss_rate":
                (tot_late + tot_shed + tot_rej) / attempts
                if attempts else 0.0,
            "goodput_rps": tot_ok / elapsed,
            "elapsed_s": elapsed,
        },
        "tenants": tenants,
        "estimator": fe_stats["estimator"],
        "verified": 0,
    }
    if verify_sample > 0:
        report["verified"] = _spot_check(frontend, loads,
                                         sample=verify_sample)
    return report


def _spot_check(frontend: ServingFrontend, loads,
                sample: int = 8) -> int:
    """Bit-identity guard: replay a sample of each tenant's point-read
    key space through the frontend AND a direct `store.fetch_reads`,
    byte-comparing the payloads. Raises on any mismatch; returns the
    number of reads verified."""
    checked = 0
    for ld in loads:
        addrs = [a for a in ld.sampler.draw(sample)
                 if isinstance(a, (int, np.integer))]
        if not addrs:
            continue
        ts = frontend._tenants[ld.name]
        ga = frontend.archives[ts.archive]
        tickets = [frontend.submit(ld.name, int(a)) for a in addrs]
        frontend.drain()
        rows, lens = ga.store.fetch_reads(np.asarray(addrs, np.int64))
        rows, lens = rows.cpu().numpy(), lens.cpu().numpy()
        for i, t in enumerate(tickets):
            if isinstance(t, Overloaded):
                continue
            res = frontend.result(t)
            if res is None or res.payload is None:
                continue
            want = rows[i, :int(lens[i])]
            if not np.array_equal(res.payload, want):
                raise AssertionError(
                    f"frontend payload for read {addrs[i]} (tenant "
                    f"{ld.name!r}) differs from direct fetch_reads")
            checked += 1
    return checked


def format_report(report: dict) -> str:
    a = report["aggregate"]
    lines = [
        f"p50={a['p50_us']:.0f}us p95={a['p95_us']:.0f}us "
        f"p99={a['p99_us']:.0f}us goodput={a['goodput_rps']:.0f}rps "
        f"miss={a['deadline_miss_rate']:.3f} "
        f"(ok={a['ok']} late={a['late']} shed={a['shed']} "
        f"rejected={a['rejected']}) verified={report['verified']}"]
    for name, t in report["tenants"].items():
        lines.append(
            f"  {name}: p95={t['p95_us']:.0f}us miss="
            f"{t['deadline_miss_rate']:.3f} hit_rate="
            f"{t['cache_hit_rate']:.2f} ok={t['ok']} shed={t['shed']} "
            f"rejected={t['rejected']}")
    return "\n".join(lines)


# ------------------------------------------------------------------ smoke
def smoke(device="cuda") -> dict:
    """Tiny closed loop at trivial load — the CI smoke: two tenants over
    one small archive on `device`, generous deadlines, and the assertion
    that NOTHING misses (no late, no shed, no rejection) plus the payload
    spot-check."""
    from repro_torch.api.archive import GenomicArchive
    from repro_torch.data.fastq import make_fastq
    from repro_torch.serving.admission import TenantPartitionPolicy
    corpus = make_fastq("platinum", n_reads=300, seed=0)
    ga = GenomicArchive.from_bytes(
        corpus, block_size=4096, device=device, cache_blocks=32,
        cache_policy=TenantPartitionPolicy({"a": 8, "b": 8}))
    fe = ServingFrontend({"corpus": ga}, max_batch=32)
    fe.register_tenant("a", "corpus", priority=0)
    fe.register_tenant("b", "corpus", priority=1)
    n = ga.n_reads
    loads = [
        TenantLoad("a", ZipfianSampler(n, seed=1), requests=40,
                   concurrency=4, deadline_us=30e6),
        TenantLoad("b", ZipfianSampler(n, seed=2), requests=40,
                   concurrency=4, deadline_us=30e6),
    ]
    report = run_closed_loop(fe, loads, verify_sample=6)
    a = report["aggregate"]
    assert a["ok"] == 80, f"expected 80 served ok, got {a}"
    assert a["deadline_miss_rate"] == 0.0, \
        f"trivial load must not miss deadlines: {a}"
    assert a["late"] == a["shed"] == a["rejected"] == 0, a
    assert report["verified"] > 0, "bit-identity spot check never ran"
    return report


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny closed-loop run; asserts zero deadline "
                         "misses at trivial load (the CI smoke)")
    ap.add_argument("--device", default="cuda",
                    help="device of the archive (default the CUDA card)")
    args = ap.parse_args()
    if args.smoke:
        report = smoke(args.device)
        print("serving traffic smoke OK")
        print(format_report(report))
    else:
        ap.print_help()


if __name__ == "__main__":
    main()
