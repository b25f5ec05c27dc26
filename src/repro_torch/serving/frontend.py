"""Multi-tenant serving frontend: continuous batching over N archives.

`ServingFrontend` serves many tenants from compressed-resident archives,
composed at the DecodePlan level the query plane was built for:

* **Continuous batching** — requests tagged `(tenant, address,
  deadline_us, priority)` enter per-tenant bounded queues; each `step()`
  forms a batch earliest-deadline-first within priority bands (band 0
  preempts band 1 regardless of deadlines), then coalesces per
  (archive, tenant) into the existing one-launch paths: read-id groups
  ride `ReadBatcher.flush` → `fetch_reads` (dedup + one selection
  decode), mixed-address groups lower through `GenomicArchive.query`
  (one DecodePlan). Grouping is per-tenant within an archive so the
  tenant cache partitions (`TenantPartitionPolicy.set_tenant`) attribute
  slot ownership and hit rates exactly; the launches per cycle stay
  bounded by tenants × archives, not by requests.

* **Deadlines + backpressure** — a `ServiceEstimator` EWMA (fed by each
  cycle's wall time and covering-block count, i.e. the instrumented
  `ReadBatcher.last_flush_us`) prices the queue: `submit()` returns a
  typed `Overloaded` instead of a ticket when the tenant's queue is full
  or the projected wait already blows the request's deadline. Requests
  that expire while queued are shed at dispatch (status "shed", no
  decode spent); requests that complete past deadline report "late".

* **Shared device budget** — the frontend owns several archives; the
  combined device footprint (compressed payloads + cache buffers) is
  checked against `device_budget_bytes` at construction and reported by
  `stats()`.

Results are exact read payloads (bit-identical to a direct
`fetch_reads`, which the traffic harness spot-checks) delivered through
tickets: `result(ticket)` / `take_results()`. Every decode runs on the
device of the archive's store through the port's kernels.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import time
from typing import Dict, List, Mapping, Optional, Union

import numpy as np

from repro_torch.api.archive import GenomicArchive
from repro_torch.serving.admission import ServiceEstimator
from repro_torch.serving.serve_step import ReadBatcher


@dataclasses.dataclass(frozen=True)
class Ticket:
    """Accepted request handle; redeem with `ServingFrontend.result`."""
    seq: int
    tenant: str


@dataclasses.dataclass(frozen=True)
class Overloaded:
    """Typed submit-time rejection (backpressure). `reason` is
    "queue_full" (the tenant's bounded queue is at capacity) or
    "deadline" (projected queue wait already exceeds the deadline)."""
    tenant: str
    reason: str
    queued: int
    projected_us: float = 0.0
    status: str = "overloaded"


@dataclasses.dataclass(frozen=True)
class ReadCorrupt:
    """Typed payload of a request whose covering blocks were
    unrecoverable (quarantined) under `on_error="partial"` — the
    per-request degradation contract: THIS request reports corruption,
    every other request in the same cycle completes normally."""
    tenant: str
    address: object
    status: str = "corrupt"


@dataclasses.dataclass
class Result:
    """Completed request. status: "ok" (served within deadline), "late"
    (served after it), "shed" (expired in queue, never decoded —
    payload None), "corrupt" (its blocks were unrecoverable under
    on_error="partial" — payload is a typed `ReadCorrupt`, never
    silently-zeroed bytes)."""
    status: str
    tenant: str
    payload: Optional[Union[np.ndarray, ReadCorrupt]]
    latency_us: float
    deadline_us: float            # the absolute deadline it was held to

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclasses.dataclass
class _Request:
    seq: int
    tenant: str
    archive: str
    address: object
    priority: int
    submit_us: float
    deadline_us: float            # absolute, math.inf when none


@dataclasses.dataclass
class _TenantState:
    archive: str
    max_queue: int
    priority: int
    queued: int = 0
    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    shed: int = 0
    late: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    corrupt: int = 0


class ServingFrontend:
    """Continuous-batching, deadline-aware front end over N archives.

        fe = ServingFrontend({"wgs": ga1, "rna": ga2})
        fe.register_tenant("clinical", "wgs", max_queue=512, priority=0)
        fe.register_tenant("batchjob", "rna", max_queue=64, priority=2)
        t = fe.submit("clinical", read_id, deadline_us=5_000)
        if isinstance(t, Overloaded): ...      # typed backpressure
        fe.drain()                             # or step() per cycle
        res = fe.result(t)                     # exact payload bytes

    `clock` is injectable (seconds, perf_counter-like) so schedulers and
    deadline math are deterministic under test.
    """

    def __init__(self, archives: Union[GenomicArchive,
                                       Mapping[str, GenomicArchive]],
                 max_batch: int = 256,
                 device_budget_bytes: Optional[int] = None,
                 estimator: Optional[ServiceEstimator] = None,
                 clock=time.perf_counter,
                 verify: Optional[bool] = None,
                 on_error: Optional[str] = None):
        if isinstance(archives, GenomicArchive):
            archives = {"default": archives}
        if not archives:
            raise ValueError("ServingFrontend needs at least one archive")
        self.archives: Dict[str, GenomicArchive] = dict(archives)
        self.max_batch = int(max_batch)
        self.clock = clock
        # detect→recover knobs for every dispatched decode (None = each
        # archive store's defaults). With on_error="partial", a request
        # whose blocks are unrecoverable resolves as a typed "corrupt"
        # Result while the rest of its cycle completes untouched.
        self.verify = verify
        self.on_error = on_error
        self.estimator = estimator or ServiceEstimator()
        self.device_budget_bytes = device_budget_bytes
        if device_budget_bytes is not None:
            used = self.device_bytes()
            if used > device_budget_bytes:
                raise ValueError(
                    f"archives + caches need {used:,}B device memory, over "
                    f"the {device_budget_bytes:,}B budget")
        self._tenants: Dict[str, _TenantState] = {}
        self._batchers: Dict[str, ReadBatcher] = {}
        self._heap: List[tuple] = []   # (priority, deadline, seq, _Request)
        self._band_depth: Dict[int, int] = {}
        self._done: Dict[int, Result] = {}
        self._seq = 0
        self.steps = 0

    # ------------------------------------------------------------- setup
    def register_tenant(self, name: str, archive: Optional[str] = None,
                        max_queue: int = 1024, priority: int = 1) -> None:
        """Declare a tenant: its home archive, bounded queue size, and
        default priority band (0 = most urgent)."""
        name = str(name)
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        if archive is None:
            archive = next(iter(self.archives))
        if archive not in self.archives:
            raise KeyError(f"unknown archive {archive!r} "
                           f"(have {sorted(self.archives)})")
        if max_queue <= 0:
            raise ValueError(f"max_queue must be positive, got {max_queue}")
        self._tenants[name] = _TenantState(archive=archive,
                                           max_queue=int(max_queue),
                                           priority=int(priority))
        pol = self._cache_policy(archive)
        if pol is not None and hasattr(pol, "set_tenant"):
            pol.set_tenant(name)       # pre-register with the partition

    def _cache_policy(self, archive_key: str):
        cache = self.archives[archive_key].store._cache
        return cache.policy if cache is not None else None

    def _batcher(self, archive_key: str) -> ReadBatcher:
        b = self._batchers.get(archive_key)
        if b is None:
            b = ReadBatcher(self.archives[archive_key],
                            max_batch=self.max_batch,
                            verify=self.verify, on_error=self.on_error)
            self._batchers[archive_key] = b
        return b

    def _now_us(self) -> float:
        return self.clock() * 1e6

    # ------------------------------------------------------------ submit
    def submit(self, tenant: str, address,
               deadline_us: Optional[float] = None,
               priority: Optional[int] = None
               ) -> Union[Ticket, Overloaded]:
        """Enqueue one request, or reject it NOW with a typed
        `Overloaded` (bounded queue full, or — once the estimator is
        warm — the projected queue wait already exceeds `deadline_us`).
        Rejection at submit is the backpressure contract: the queue
        never grows past what the measured service rate can clear."""
        ts = self._tenants.get(str(tenant))
        if ts is None:
            raise KeyError(f"unknown tenant {tenant!r} "
                           f"(register_tenant first)")
        tenant = str(tenant)
        if ts.queued >= ts.max_queue:
            ts.rejected += 1
            return Overloaded(tenant, "queue_full", queued=ts.queued)
        band = ts.priority if priority is None else int(priority)
        now = self._now_us()
        if deadline_us is not None and self.estimator.warm:
            # everything queued in this band or a more urgent one is
            # served first; each scheduler cycle clears max_batch of it
            ahead = sum(d for p, d in self._band_depth.items() if p <= band)
            cycles = ahead // self.max_batch + 1
            projected = self.estimator.projected_wait_us(cycles)
            if projected > deadline_us:
                ts.rejected += 1
                return Overloaded(tenant, "deadline", queued=ahead,
                                  projected_us=projected)
        seq = self._seq
        self._seq += 1
        abs_deadline = (now + float(deadline_us) if deadline_us is not None
                        else math.inf)
        req = _Request(seq=seq, tenant=tenant, archive=ts.archive,
                       address=address, priority=band, submit_us=now,
                       deadline_us=abs_deadline)
        heapq.heappush(self._heap, (band, abs_deadline, seq, req))
        ts.queued += 1
        ts.submitted += 1
        self._band_depth[band] = self._band_depth.get(band, 0) + 1
        return Ticket(seq=seq, tenant=tenant)

    def pending(self) -> int:
        return len(self._heap)

    # -------------------------------------------------------- scheduling
    def step(self) -> int:
        """One scheduler cycle: pop up to `max_batch` requests in
        (priority band, deadline) order, shed the already-expired ones,
        coalesce the rest per (archive, tenant), and dispatch each group
        as ONE batched decode. Returns the number of requests resolved
        (served + shed) this cycle."""
        now = self._now_us()
        batch: List[_Request] = []
        resolved = 0
        while self._heap and len(batch) < self.max_batch:
            _, _, _, req = heapq.heappop(self._heap)
            ts = self._tenants[req.tenant]
            ts.queued -= 1
            self._band_depth[req.priority] -= 1
            if req.deadline_us < now:
                # graceful shedding: an expired request costs zero decode
                # work and resolves immediately as shed
                ts.shed += 1
                self._done[req.seq] = Result(
                    status="shed", tenant=req.tenant, payload=None,
                    latency_us=now - req.submit_us,
                    deadline_us=req.deadline_us)
                resolved += 1
                continue
            batch.append(req)
        if not batch:
            return resolved
        groups: Dict[tuple, List[_Request]] = {}
        for req in batch:
            groups.setdefault((req.archive, req.tenant), []).append(req)
        cycle_us = 0.0
        cycle_blocks = 0
        for (akey, tenant), reqs in groups.items():
            us, blocks = self._dispatch(akey, tenant, reqs)
            cycle_us += us
            cycle_blocks += blocks
            resolved += len(reqs)
        self.estimator.observe(cycle_us, n_blocks=cycle_blocks)
        self.steps += 1
        return resolved

    def _dispatch(self, akey: str, tenant: str,
                  reqs: List[_Request]) -> tuple:
        """One coalesced decode for one (archive, tenant) group. Returns
        (service_us, unique covering blocks) for the estimator."""
        ga = self.archives[akey]
        ts = self._tenants[tenant]
        pol = self._cache_policy(akey)
        if pol is not None and hasattr(pol, "set_tenant"):
            pol.set_tenant(tenant)
        info0 = ga.cache_info()
        addrs = [r.address for r in reqs]
        all_ids = all(isinstance(a, (int, np.integer)) for a in addrs)
        t0 = self.clock()
        if all_ids and ga.store.index is not None:
            # the batched read-id fast path: dedup + one selection decode,
            # and the batcher's own flush instrumentation times it
            b = self._batcher(akey)
            tickets = [b.submit(int(a)) for a in addrs]
            out = b.flush()
            payloads = [out[t] for t in tickets]
            corrupt = [t in b.last_corrupt_tickets for t in tickets]
            svc_us = b.stats()["last_flush_us"]
        else:
            rows, lens = ga.query(addrs, verify=self.verify,
                                  on_error=self.on_error)
            rows, lens = rows.cpu().numpy(), lens.cpu().numpy()
            payloads = [rows[i, :int(lens[i])] for i in range(len(reqs))]
            lc = np.asarray(ga.last_corrupt)
            corrupt = (lc[:len(reqs)].tolist() if lc.size >= len(reqs)
                       else [False] * len(reqs))
            svc_us = (self.clock() - t0) * 1e6
        done = self._now_us()
        info1 = ga.cache_info()
        ts.cache_hits += info1["hits"] - info0["hits"]
        ts.cache_misses += info1["misses"] - info0["misses"]
        blocks = (info1["hits"] - info0["hits"]
                  + info1["misses"] - info0["misses"])
        for req, payload, bad in zip(reqs, payloads, corrupt):
            ts.completed += 1
            if bad:
                # per-request degradation: THIS request reports a typed
                # corruption outcome; its batchmates complete normally
                ts.corrupt += 1
                self._done[req.seq] = Result(
                    status="corrupt", tenant=tenant,
                    payload=ReadCorrupt(tenant=tenant, address=req.address),
                    latency_us=done - req.submit_us,
                    deadline_us=req.deadline_us)
                continue
            late = done > req.deadline_us
            ts.late += int(late)
            self._done[req.seq] = Result(
                status="late" if late else "ok", tenant=tenant,
                payload=payload, latency_us=done - req.submit_us,
                deadline_us=req.deadline_us)
        return svc_us, max(blocks, 0)

    def drain(self, max_steps: int = 1_000_000) -> int:
        """Run scheduler cycles until every queue is empty. Returns the
        number of requests resolved."""
        total = 0
        for _ in range(max_steps):
            if not self._heap:
                break
            total += self.step()
        return total

    # ------------------------------------------------------------ results
    def result(self, ticket: Ticket) -> Optional[Result]:
        """Pop the completed Result for a ticket (None if still queued)."""
        return self._done.pop(ticket.seq, None)

    def take_results(self) -> Dict[int, Result]:
        """Pop every completed result, keyed by ticket seq."""
        out, self._done = self._done, {}
        return out

    # -------------------------------------------------------------- stats
    def device_bytes(self) -> int:
        """Combined device footprint of every archive: compressed
        payloads + cache slot buffers (the shared-budget accounting).
        A mesh-partitioned archive contributes the SUM of its per-shard
        compressed slices + per-shard cache slots — what the whole mesh
        holds, not one replica."""
        total = 0
        for ga in self.archives.values():
            sr = getattr(ga.store, "sharded", None)
            if sr is not None:
                # the sharded residency owns both compressed and cache
                # bytes; cache_info() falls through to its cache, so its
                # buffer_bytes are not added again
                total += sr.device_bytes()
                continue
            total += ga.stats().compressed_device_bytes
            total += ga.cache_info()["buffer_bytes"]
        return total

    def stats(self) -> dict:
        tenants = {}
        for name, ts in self._tenants.items():
            acc = ts.cache_hits + ts.cache_misses
            tenants[name] = {
                "archive": ts.archive, "priority": ts.priority,
                "queued": ts.queued, "submitted": ts.submitted,
                "completed": ts.completed, "rejected": ts.rejected,
                "shed": ts.shed, "late": ts.late,
                "corrupt": ts.corrupt,
                "cache_hits": ts.cache_hits,
                "cache_misses": ts.cache_misses,
                "cache_hit_rate": (ts.cache_hits / acc) if acc else 0.0,
            }
        return {"tenants": tenants, "steps": self.steps,
                "pending": len(self._heap),
                "estimator": self.estimator.info(),
                "device_bytes": self.device_bytes(),
                "device_budget_bytes": self.device_budget_bytes}
