"""`repro_torch.obs`, the spans and counters of the port's request path,
on the CPU: a span is a no-op without a profiler; under one, the stages
of `fetch_block_range` and `fetch_reads` nest inside their entry span;
each route of `DeviceExecutor.run` bumps its own counter; the block
counters read what each route covered and decoded; and the reference's
parity counters read as the reference's do."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core import encoder as renc
from repro.core import format as rfmt
from repro.core.index import ReadIndex as RIndex
from repro.core.residency import CompressedResidentStore as RStore
from repro_torch import obs
from repro_torch.core import format as pfmt
from repro_torch.core.encoder import encode
from repro_torch.core.index import ReadIndex
from repro_torch.core.residency import CompressedResidentStore
from repro_torch.data.fastq import make_fastq

BS = 4096


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    data = make_fastq("noisy", n_reads=300, seed=3)
    return data, encode(data, block_size=BS), ReadIndex.build(data, BS)


def _store(corpus, **kw):
    data, a, index = corpus
    return CompressedResidentStore(a, index, device="cpu", **kw)


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    obs.SPAN_LOG.clear()
    a, b = obs.span("plan"), obs.span("gather")
    assert a is b
    with a:
        pass
    assert not obs.SPAN_LOG


def _nested(events, outer, inner) -> bool:
    """Every `inner` event lies inside some `outer` event."""
    return all(any(o0 <= i0 and i1 <= o1 for o0, o1 in events[outer])
               for i0, i1 in events[inner])


@pytest.mark.parametrize("entry", ["fetch_block_range", "fetch_reads"])
def test_stages_nest_inside_the_entry_span(corpus, entry):
    st = _store(corpus)
    n = st.decoder.da.n_blocks
    call = {"fetch_block_range": lambda: st.fetch_block_range(0, n),
            "fetch_reads": lambda: st.fetch_reads(
                np.arange(st.index.n_reads))}[entry]
    call()
    obs.SPAN_LOG.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    events = {}
    for e in prof.events():
        if e.name.startswith(obs.PREFIX):
            events.setdefault(e.name[len(obs.PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    stages = ("upload", "cover_sync", "entropy", "match", "gather")
    assert set(events) >= {entry, "plan", "execute", *stages}
    assert len(events[entry]) == 1
    for inner in ("plan", "execute"):
        assert _nested(events, entry, inner)
    for inner in stages:
        assert _nested(events, "execute", inner)
    # the program's own log holds the same spans, in the same nesting
    log = {}
    for name, t0, t1 in obs.SPAN_LOG:
        log.setdefault(name, []).append((t0, t1))
    assert {k: len(v) for k, v in log.items()} == {
        k: len(v) for k, v in events.items()}
    for inner in stages:
        assert _nested(log, "execute", inner)
    obs.SPAN_LOG.clear()
    call()
    assert not obs.SPAN_LOG


ROUTES = ("route.fused_spans", "route.fused_ids", "route.staged")


@pytest.mark.parametrize("route", ["fused_spans", "fused_ids", "staged",
                                   "mode1"])
def test_each_route_bumps_its_counter_and_counts_its_blocks(corpus, route):
    if route == "staged":
        st = _store(corpus, cache_blocks=64, verify=True)
    else:
        st = _store(corpus)
    dec = st.decoder
    n = dec.da.n_blocks
    call = {"fused_spans": lambda: st.fetch_block_range(0, n),
            "fused_ids": lambda: st.fetch_reads(np.arange(st.index.n_reads)),
            "staged": lambda: st.fetch_block_range(0, n),
            "mode1": lambda: st.fetch_block_range(0, n, mode2=False)}[route]
    obs.reset_counts()
    call()
    c = dict(obs.COUNTS)
    want = {"fused_spans": "route.fused_spans", "fused_ids": "route.fused_ids",
            "staged": "route.staged", "mode1": "route.staged"}[route]
    assert {k: c[k] for k in ROUTES} == {k: int(k == want) for k in ROUTES}
    assert c["requests"] == 1
    assert c["blocks.covered"] == n
    if route.startswith("fused"):
        assert c["blocks.decoded"] == n
    else:
        # the staged routes pad each depth bucket to a power of two, as
        # the reference does, and count what they materialized
        assert c["blocks.decoded"] == dec.decoded_blocks_last >= n
    if route == "staged":
        # a second call is all cache hits: covered again, nothing decoded
        call()
        assert obs.COUNTS["blocks.covered"] == 2 * n
        assert obs.COUNTS["blocks.decoded"] == c["blocks.decoded"]
        assert obs.COUNTS["route.staged"] == 2


def test_anchor_free_global_fused_route_decodes_the_whole_prefix():
    data = make_fastq("platinum", n_reads=200, seed=5)
    a = encode(data, block_size=BS, mode="global")
    st = CompressedResidentStore(a, ReadIndex.build(data, BS), device="cpu")
    n = a.n_blocks
    assert n >= 4
    obs.reset_counts()
    st.fetch_block_range(n - 2, n)
    assert obs.COUNTS["route.fused_spans"] == 1
    assert obs.COUNTS["blocks.covered"] == 2
    assert obs.COUNTS["blocks.decoded"] == n


def test_host_syncs_count_the_fused_routes_sites(corpus):
    """Five pageable uploads and the covering set's size read back on a
    block range; one upload and the read back on read ids. A card counts
    the same calls as `torch.cuda.set_sync_debug_mode` reports them
    (`tests/test_torch_cuda.py`)."""
    st = _store(corpus)
    obs.reset_counts()
    st.fetch_block_range(0, st.decoder.da.n_blocks)
    assert obs.COUNTS["host_syncs"] == 6
    obs.reset_counts()
    st.fetch_reads(np.arange(10))
    assert obs.COUNTS["host_syncs"] == 2


def test_parity_counters_read_as_the_reference(corpus):
    """`decoded_blocks_last` and `launch_rounds_last` after the same calls
    on each route, port and reference: the new counters moved nothing
    (the fused routes leave both stale in both packages)."""
    data, _, _ = corpus
    ra = renc.encode(data, block_size=BS)
    ridx = RIndex.build(data, BS)
    pidx = ReadIndex(starts=ridx.starts.copy(), block_size=BS)
    pa = pfmt.deserialize(rfmt.serialize(ra))
    n = ra.n_blocks
    for kw in ({}, {"cache_blocks": 64, "verify": True}):
        rs = RStore(ra, ridx, backend="ref", **kw)
        ps = CompressedResidentStore(pa, pidx, device="cpu", **kw)
        for call in (lambda s: s.fetch_block_range(1, n - 1),
                     lambda s: s.fetch_reads(np.arange(0, 40, 3)),
                     lambda s: s.fetch_block_range(0, 2, mode2=False),
                     lambda s: s.fetch_records(np.arange(3), 500)):
            call(rs), call(ps)
            assert ps.decoder.decoded_blocks_last == \
                rs.decoder.decoded_blocks_last
            assert list(ps.decoder.launch_rounds_last) == \
                list(rs.decoder.launch_rounds_last)
