"""The PyTorch port's multi-tenant serving plane on the CPU: every test
of the reference's `tests/test_serving_frontend.py` (continuous
batching, deadline/priority scheduling, typed backpressure, tenant cache
partitions, the closed-loop traffic harness) on port archives, and the
port held against the reference: two frontends driven by the same fake
clock, tenants and submissions give the same statuses, payload bytes,
`Overloaded` rejections and counters; `ReadBatcher` dedups and flags
corrupt tickets as the reference's does."""
import numpy as np
import pytest

from repro_torch.api.archive import GenomicArchive
from repro_torch.serving.admission import (ServiceEstimator,
                                           TenantPartitionPolicy)
from repro_torch.serving.frontend import Overloaded, ServingFrontend, Ticket
from repro_torch.serving.serve_step import ReadBatcher
from repro_torch.serving.traffic import (FlashCrowdSampler, MixSampler,
                                         ScanSampler, TenantLoad,
                                         ZipfianSampler, run_closed_loop)

BS = 4096


@pytest.fixture(scope="module")
def ga_a(fastq_platinum):
    return GenomicArchive.from_bytes(fastq_platinum, block_size=BS,
                                     device="cpu", cache_blocks=24,
                                     cache_policy="tinylfu")


@pytest.fixture(scope="module")
def ga_b(fastq_noisy):
    return GenomicArchive.from_bytes(fastq_noisy, block_size=BS,
                                     device="cpu")


class FakeClock:
    """Deterministic injectable clock (seconds)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance_us(self, us):
        self.t += us / 1e6


def _frontend(archives, **kw):
    fe = ServingFrontend(archives, **kw)
    return fe


# ------------------------------------------------------------ correctness
def test_frontend_bit_identical_across_archives_and_tenants(ga_a, ga_b):
    """Acceptance (c): every decode through the frontend is bit-identical
    to a direct fetch_reads — across two archives, three tenants,
    duplicate ids, and a mixed named-region address."""
    fe = _frontend({"plat": ga_a, "noisy": ga_b}, max_batch=16)
    fe.register_tenant("t0", "plat")
    fe.register_tenant("t1", "plat", priority=0)
    fe.register_tenant("t2", "noisy")
    rng = np.random.default_rng(0)
    ids_a = rng.integers(0, ga_a.n_reads, size=12).tolist()
    ids_a += ids_a[:3]                       # duplicates coalesce fine
    ids_b = rng.integers(0, ga_b.n_reads, size=7).tolist()
    tickets = ([("t0", i, fe.submit("t0", i)) for i in ids_a[:8]]
               + [("t1", i, fe.submit("t1", i)) for i in ids_a[8:]]
               + [("t2", i, fe.submit("t2", i)) for i in ids_b])
    region = fe.submit("t0", f"SRR0.{ids_a[0]}:1-40")
    assert all(isinstance(t, Ticket) for _, _, t in tickets)
    fe.drain()
    rows_a, lens_a = ga_a.store.fetch_reads(np.asarray(ids_a, np.int64))
    rows_b, lens_b = ga_b.store.fetch_reads(np.asarray(ids_b, np.int64))
    rows_a, lens_a = rows_a.numpy(), lens_a.numpy()
    rows_b, lens_b = rows_b.numpy(), lens_b.numpy()
    for tenant, rid, t in tickets:
        res = fe.result(t)
        assert res is not None and res.ok, (tenant, rid, res)
        if tenant == "t2":
            j = ids_b.index(rid)
            want = rows_b[j, :int(lens_b[j])]
        else:
            j = ids_a.index(rid)
            want = rows_a[j, :int(lens_a[j])]
        np.testing.assert_array_equal(res.payload, want)
    res = fe.result(region)
    np.testing.assert_array_equal(res.payload,
                                  ga_a[f"SRR0.{ids_a[0]}:1-40"])


def test_priority_bands_preempt_deadlines(ga_a):
    """Band 0 dispatches before band 1 even when band 1's deadlines are
    tighter; within a band, earliest deadline first."""
    clk = FakeClock()
    fe = _frontend({"plat": ga_a}, max_batch=2, clock=clk)
    fe.register_tenant("lo", "plat", priority=1)
    fe.register_tenant("hi", "plat", priority=0)
    t_lo1 = fe.submit("lo", 1, deadline_us=1e6)
    t_lo2 = fe.submit("lo", 2, deadline_us=2e6)
    t_hi1 = fe.submit("hi", 3, deadline_us=9e6)   # loosest deadline, but
    t_hi2 = fe.submit("hi", 4, deadline_us=8e6)   # band 0 goes first
    fe.step()                                     # one cycle = 2 requests
    done = fe.take_results()
    assert set(done) == {t_hi1.seq, t_hi2.seq}
    fe.step()
    done = fe.take_results()
    assert set(done) == {t_lo1.seq, t_lo2.seq}


def test_edf_within_band(ga_a):
    clk = FakeClock()
    fe = _frontend({"plat": ga_a}, max_batch=1, clock=clk)
    fe.register_tenant("t", "plat")
    late = fe.submit("t", 5, deadline_us=5e6)
    soon = fe.submit("t", 6, deadline_us=1e6)
    fe.step()
    assert set(fe.take_results()) == {soon.seq}
    fe.step()
    assert set(fe.take_results()) == {late.seq}


# ----------------------------------------------------------- backpressure
def test_bounded_queue_rejects_with_typed_overloaded(ga_a):
    fe = _frontend({"plat": ga_a})
    fe.register_tenant("t", "plat", max_queue=2)
    assert isinstance(fe.submit("t", 0), Ticket)
    assert isinstance(fe.submit("t", 1), Ticket)
    r = fe.submit("t", 2)
    assert isinstance(r, Overloaded)
    assert r.reason == "queue_full" and r.tenant == "t"
    assert fe.stats()["tenants"]["t"]["rejected"] == 1
    fe.drain()
    assert isinstance(fe.submit("t", 2), Ticket)   # drained queue reopens
    fe.drain()


def test_infeasible_deadline_rejected_when_estimator_warm(ga_a):
    clk = FakeClock()
    est = ServiceEstimator()
    fe = _frontend({"plat": ga_a}, max_batch=4, clock=clk, estimator=est)
    fe.register_tenant("t", "plat")
    # cold estimator: anything is admitted
    assert isinstance(fe.submit("t", 0, deadline_us=1.0), Ticket)
    fe.drain()
    fe.take_results()
    assert est.warm
    # pretend measured service time is 10ms per cycle: a 1ms deadline
    # behind a full cycle of backlog cannot be met → typed rejection
    est.batch_us = 10_000.0
    for i in range(4):
        assert isinstance(fe.submit("t", i, deadline_us=1e9), Ticket)
    r = fe.submit("t", 9, deadline_us=1_000.0)
    assert isinstance(r, Overloaded)
    assert r.reason == "deadline"
    assert r.projected_us >= 10_000.0
    # a generous deadline still gets in
    assert isinstance(fe.submit("t", 9, deadline_us=1e9), Ticket)
    fe.drain()


def test_expired_requests_shed_without_decode(ga_a):
    clk = FakeClock()
    fe = _frontend({"plat": ga_a}, clock=clk)
    fe.register_tenant("t", "plat")
    doomed = fe.submit("t", 0, deadline_us=100.0)
    safe = fe.submit("t", 1)                       # no deadline
    clk.advance_us(1_000)                          # deadline passes in queue
    launches0 = ga_a.cache_info()["decode_launches"]
    fe.step()
    res_doomed = fe.result(doomed)
    res_safe = fe.result(safe)
    assert res_doomed.status == "shed" and res_doomed.payload is None
    assert res_safe.ok and res_safe.payload is not None
    assert fe.stats()["tenants"]["t"]["shed"] == 1
    # the shed request must not have cost decode work of its own: the
    # only launches are the safe request's
    assert ga_a.cache_info()["decode_launches"] - launches0 <= 1


def test_late_completion_reported(ga_a):
    """A request served after its deadline (service time, not queue wait)
    completes with status 'late' and counts in stats."""
    clk = FakeClock()
    fe = _frontend({"plat": ga_a}, clock=clk)
    fe.register_tenant("t", "plat")

    t = fe.submit("t", 3, deadline_us=50.0)
    real_dispatch = fe._dispatch

    def slow_dispatch(akey, tenant, reqs):
        clk.advance_us(500.0)                      # service blows deadline
        return real_dispatch(akey, tenant, reqs)

    fe._dispatch = slow_dispatch
    fe.step()
    res = fe.result(t)
    assert res.status == "late" and res.payload is not None
    assert fe.stats()["tenants"]["t"]["late"] == 1


def test_unknown_tenant_and_archive_errors(ga_a):
    fe = _frontend({"plat": ga_a})
    with pytest.raises(KeyError, match="unknown tenant"):
        fe.submit("ghost", 0)
    with pytest.raises(KeyError, match="unknown archive"):
        fe.register_tenant("t", "nope")
    fe.register_tenant("t", "plat")
    with pytest.raises(ValueError, match="already registered"):
        fe.register_tenant("t", "plat")


def test_device_budget_checked(ga_a):
    need = (ga_a.stats().compressed_device_bytes
            + ga_a.cache_info()["buffer_bytes"])
    with pytest.raises(ValueError, match="budget"):
        ServingFrontend({"plat": ga_a}, device_budget_bytes=need - 1)
    fe = ServingFrontend({"plat": ga_a}, device_budget_bytes=need)
    assert fe.stats()["device_bytes"] == need


# ------------------------------------------------------ estimator plumbing
def test_estimator_observes_cycles_and_batcher_latency(ga_a):
    fe = _frontend({"plat": ga_a}, max_batch=8)
    fe.register_tenant("t", "plat")
    for i in range(6):
        fe.submit("t", i)
    fe.drain()
    est = fe.stats()["estimator"]
    assert est["observations"] >= 1
    assert est["batch_us"] > 0
    # the read-id path is timed by the instrumented ReadBatcher
    b = fe._batchers["plat"]
    st = b.stats()
    assert st["last_flush_us"] > 0 and st["flushes"] >= 1
    assert st["avg_flush_us"] > 0


def test_read_batcher_accepts_archive_uniformly(ga_a):
    """Satellite: ReadBatcher takes a GenomicArchive directly and its
    cache_info/stats surfaces work without reaching through .store."""
    b = ReadBatcher(ga_a, max_batch=8)
    assert b.archive is ga_a and b.store is ga_a.store
    t = b.submit(0)
    out = b.flush()
    np.testing.assert_array_equal(out[t], ga_a[0])
    assert b.cache_info() == ga_a.cache_info()
    assert b.stats()["last_flush_us"] > 0


# ----------------------------------------------- tenant cache partitions
def test_tenant_hit_rate_accounting_and_floor_protection(fastq_platinum):
    """A tenant with a floored partition keeps its hit rate under a
    cross-tenant thrash: tenant b cycles through cold blocks but can
    never evict a's floor-protected hot set."""
    pol = TenantPartitionPolicy({"a": 6, "b": 2})
    ga = GenomicArchive.from_bytes(fastq_platinum, block_size=BS,
                                   device="cpu", cache_blocks=8,
                                   cache_policy=pol)
    fe = _frontend({"c": ga}, max_batch=16)
    fe.register_tenant("a", "c")
    fe.register_tenant("b", "c")
    rng = np.random.default_rng(5)
    hot = rng.integers(0, 40, size=6).tolist()     # small hot set for a
    warm_misses = None
    for round_ in range(6):
        for i in hot:
            fe.submit("a", int(i))
        for i in rng.integers(0, ga.n_reads, size=12):
            fe.submit("b", int(i))                 # b thrashes the tail
        fe.drain()
        fe.take_results()
        if round_ == 0:
            warm_misses = fe.stats()["tenants"]["a"]["cache_misses"]
    st = fe.stats()["tenants"]
    assert st["a"]["cache_hits"] + st["a"]["cache_misses"] > 0
    assert st["b"]["cache_hits"] + st["b"]["cache_misses"] > 0
    # the floor guarantee, observed: once a's hot set is resident, five
    # rounds of b's thrash cannot evict it — a never misses again
    assert st["a"]["cache_misses"] == warm_misses, \
        f"tenant a thrashed out of its floor: {st}"
    # and shows up as a structurally better hit rate than the thrasher's
    assert st["a"]["cache_hit_rate"] > st["b"]["cache_hit_rate"]
    counts = pol.resident_counts()
    assert 1 <= counts["a"] <= 6, f"ownership accounting off: {counts}"


# ------------------------------------------------------- traffic harness
def test_closed_loop_trivial_load_zero_misses(ga_a):
    fe = _frontend({"plat": ga_a}, max_batch=16)
    fe.register_tenant("a", "plat", priority=0)
    fe.register_tenant("b", "plat")
    loads = [
        TenantLoad("a", ZipfianSampler(ga_a.n_reads, seed=1),
                   requests=24, concurrency=4, deadline_us=60e6),
        TenantLoad("b", ZipfianSampler(ga_a.n_reads, seed=2),
                   requests=24, concurrency=4, deadline_us=60e6),
    ]
    report = run_closed_loop(fe, loads, verify_sample=4)
    agg = report["aggregate"]
    assert agg["ok"] == 48
    assert agg["deadline_miss_rate"] == 0.0
    assert agg["p50_us"] <= agg["p95_us"] <= agg["p99_us"]
    assert agg["goodput_rps"] > 0
    assert report["verified"] > 0


def test_overload_sheds_low_priority_keeps_high(ga_a):
    """Acceptance (b) shape: under overload the low-priority tenant is
    rejected/shed with typed Overloaded results while the high-priority
    tenant completes everything in deadline."""
    fe = _frontend({"plat": ga_a}, max_batch=4)
    fe.register_tenant("hi", "plat", priority=0, max_queue=64)
    fe.register_tenant("lo", "plat", priority=2, max_queue=6)
    loads = [
        TenantLoad("hi", ZipfianSampler(ga_a.n_reads, seed=3),
                   requests=24, concurrency=3, deadline_us=60e6),
        TenantLoad("lo", ZipfianSampler(ga_a.n_reads, seed=4),
                   requests=60, concurrency=24, deadline_us=60e6),
    ]
    report = run_closed_loop(fe, loads, verify_sample=0)
    hi, lo = report["tenants"]["hi"], report["tenants"]["lo"]
    assert hi["ok"] == 24 and hi["rejected"] == 0 and hi["shed"] == 0
    assert lo["rejected"] > 0, "bounded queue never pushed back"
    assert report["aggregate"]["ok"] == hi["ok"] + lo["ok"]


def test_scan_and_mix_samplers_through_frontend(ga_a):
    fe = _frontend({"plat": ga_a}, max_batch=8)
    fe.register_tenant("scan", "plat")
    scans = ScanSampler(ga_a.raw_size, span_bytes=BS * 2, seed=0)
    mix = MixSampler([ZipfianSampler(ga_a.n_reads, seed=7), scans],
                     [0.5, 0.5], seed=8)
    addrs = mix.draw(10)
    tks = [fe.submit("scan", a) for a in addrs]
    fe.drain()
    for a, t in zip(addrs, tks):
        res = fe.result(t)
        assert res.ok
        if isinstance(a, slice):
            np.testing.assert_array_equal(res.payload, ga_a[a])
        else:
            np.testing.assert_array_equal(res.payload, ga_a[int(a)])


def test_flash_crowd_sampler_shifts_hot_set():
    s = FlashCrowdSampler(1000, seed=0, shift_at=100, hot_n=4,
                          hot_frac=1.0)
    before = set(s.draw(100))
    after = set(s.draw(200))
    assert len(after) <= 6                     # crowd concentrates
    assert set(s.hot.tolist()) >= after
    assert len(before) > len(after)


# ------------------------------------------------- held to the reference
def _drive(fe, clk, script):
    """Run `script` on one frontend: ("submit", tenant, addr, deadline),
    ("advance", us), ("step",), ("drain",), ("estimate", batch_us). Returns
    what a client sees, in order: each submit's rejection (reason, queued,
    projected) or ticket, and every result (seq, status, tenant, bytes)."""
    seen, tickets = [], []
    for op in script:
        if op[0] == "submit":
            t = fe.submit(op[1], op[2], deadline_us=op[3])
            tickets.append(t)
            # either package's `Overloaded` (the reference's is its own)
            seen.append(("overloaded", t.tenant, t.reason, t.queued,
                         t.projected_us) if hasattr(t, "reason")
                        else ("ticket", t.seq, t.tenant))
        elif op[0] == "advance":
            clk.advance_us(op[1])
        elif op[0] == "estimate":
            # pin the estimator's wall-clock service time so that deadline
            # admission decides alike in both packages
            fe.estimator.batch_us = op[1]
        else:
            getattr(fe, op[0])()
    for seq, res in sorted(fe.take_results().items()):
        payload = (None if res.payload is None else
                   ("corrupt", res.payload.tenant) if res.status == "corrupt"
                   else bytes(res.payload))
        seen.append((seq, res.status, res.tenant, payload, res.latency_us,
                     res.deadline_us))
    return seen


def _stats(fe):
    st = fe.stats()
    st.pop("device_bytes")                  # the port stores i64 offsets
    est = st.pop("estimator")               # wall-clock fields differ
    return st, est["observations"]


def test_frontend_matches_reference(fastq_platinum):
    """The same fake clock, tenants and submissions through the
    reference's frontend and the port's: equal statuses, payload bytes,
    typed rejections, cache counters and frontend counters."""
    from repro.api.archive import GenomicArchive as RGA
    from repro.serving.admission import TenantPartitionPolicy as RPolicy
    from repro.serving.frontend import ServingFrontend as RFrontend
    rng = np.random.default_rng(17)
    script = []
    for rnd in range(4):
        script.append(("estimate", 10_000.0))
        for i in rng.integers(0, 400, 10):
            script.append(("submit", "a", int(i), 1e9))
        for i in rng.integers(0, 400, 8):
            script.append(("submit", "b", int(i), None))
        script += [("submit", "b", slice(1000 * rnd, 1000 * rnd + 3000),
                    2e6),
                   ("submit", "a", f"SRR0.{rnd + 3}:2-30", 5e6),
                   ("submit", "a", int(rng.integers(0, 400)), 1_000.0),
                   ("submit", "a", 7, 50.0),
                   ("advance", 100.0), ("step",), ("advance", 5_000.0),
                   ("step",), ("drain",)]
    out = []
    for GA, Frontend, Policy, kw in (
            (RGA, RFrontend, RPolicy, dict(backend="ref")),
            (GenomicArchive, ServingFrontend, TenantPartitionPolicy,
             dict(device="cpu"))):
        ga = GA.from_bytes(fastq_platinum, block_size=BS, cache_blocks=12,
                           cache_policy=Policy({"a": 6, "b": 4}), **kw)
        clk = FakeClock()
        fe = Frontend({"plat": ga}, max_batch=8, clock=clk)
        fe.register_tenant("a", "plat", priority=0, max_queue=16)
        fe.register_tenant("b", "plat", priority=2, max_queue=6)
        out.append((_drive(fe, clk, script), _stats(fe), ga.cache_info(),
                    ga.store._cache.policy.resident_counts()))
    want, got = out
    assert got[0] == want[0]
    assert got[1:] == want[1:]
    statuses = {s[1] for s in got[0] if isinstance(s[0], int)}
    assert {"ok", "shed"} <= statuses
    assert any(s[0] == "overloaded" and s[2] == "queue_full" for s in got[0])
    assert any(s[0] == "overloaded" and s[2] == "deadline" for s in got[0])


def test_read_batcher_dedup_matches_reference(fastq_platinum):
    """Duplicates anywhere in the queue decode once, however the queue
    slices into `max_batch` fetches: the same bytes per ticket and the
    same counters as the reference's batcher."""
    from repro.api.archive import GenomicArchive as RGA
    from repro.serving.serve_step import ReadBatcher as RBatcher
    rga = RGA.from_bytes(fastq_platinum, block_size=BS, backend="ref",
                         cache_blocks=8)
    pga = GenomicArchive.from_bytes(fastq_platinum, block_size=BS,
                                    device="cpu", cache_blocks=8)
    ids = np.random.default_rng(3).integers(0, 40, 30).tolist()
    ids += ids[:7]
    outs = []
    for b in (RBatcher(rga, max_batch=4), ReadBatcher(pga, max_batch=4)):
        tickets = [b.submit(i) for i in ids]
        got = b.flush()
        outs.append(([bytes(got[t]) for t in tickets],
                     {k: v for k, v in b.stats().items()
                      if not k.endswith("flush_us")}, b.cache_info()))
    assert outs[1] == outs[0]
    assert outs[1][1]["unique_fetched"] == len(set(ids))
    assert outs[1][1]["served"] == len(ids)
    assert outs[1][0] == [pga[i].tobytes() for i in ids]


def test_read_batcher_corrupt_tickets_match_reference():
    """Under on_error="partial" over a parity group with two corrupt
    blocks, the tickets whose reads touch them land in
    `last_corrupt_tickets` — the same tickets as the reference's — and
    every other ticket carries its exact bytes."""
    from repro.api.archive import GenomicArchive as RGA
    from repro.resilience.faults import FaultInjector as RInjector
    from repro.serving.serve_step import ReadBatcher as RBatcher
    from repro_torch.resilience.faults import FaultInjector
    from test_torch_resilience import DATA, _double_corruption_blocks
    kw = dict(record_bytes=128, block_size=256, parity_group=4,
              cache_blocks=8)
    rga = RGA.from_records(DATA, backend="ref", **kw)
    pga = GenomicArchive.from_records(DATA, device="cpu", **kw)
    blks = _double_corruption_blocks(pga.store.decoder)
    ids = np.arange(pga.n_reads)
    outs = []
    for ga, fi, B in ((rga, RInjector(seed=7), RBatcher),
                      (pga, FaultInjector(seed=7), ReadBatcher)):
        for blk in blks:
            fi.flip_payload_word(ga.store.decoder, block=blk)
        b = B(ga, max_batch=64, verify=True, on_error="partial")
        tickets = [b.submit(int(i)) for i in ids]
        got = b.flush()
        outs.append(([bytes(got[t]) for t in tickets],
                     sorted(b.last_corrupt_tickets), b.corrupt_served,
                     fi.log, ga.recover_info(), ga.cache_info()))
    assert outs[1] == outs[0]
    corrupt = outs[1][1]
    assert corrupt and len(corrupt) < ids.size
    for t, payload in enumerate(outs[1][0]):
        if t not in corrupt:
            assert payload == DATA[128 * t:128 * (t + 1)]


def test_traffic_smoke_on_the_cpu():
    from repro_torch.serving import traffic
    report = traffic.smoke("cpu")
    assert report["aggregate"]["ok"] == 80 and report["verified"] > 0
    assert "p50=" in traffic.format_report(report)
