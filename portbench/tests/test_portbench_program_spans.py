"""The readers of the program's own spans and counters (CPU, synthetic
inputs): the device trace is the same with the program's spans or
without them, idle gaps are named by the innermost program span, the
gather's device time is cut out of the stream, and each new per-layer
reader returns its value, or None where it has nothing to read."""
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness, program_spans  # noqa: E402
from portbench.trace import Trace, from_profiler  # noqa: E402
from repro_torch import obs  # noqa: E402

HTOD = "Memcpy HtoD (Pageable -> Device)"
OFF_US = 100.0 - 1e6        # profiler clock = host seconds * 1e6 + OFF_US

# one request, in ms after its issue: (name, start, end)
REQUEST = [("fetch_block_range", 0.1, 9.9), ("plan", 0.2, 1.0),
           ("execute", 1.1, 9.8), ("plan", 1.2, 1.5), ("upload", 1.6, 5.6),
           ("upload", 5.7, 5.8), ("cover_sync", 5.9, 6.9),
           ("entropy", 7.0, 7.2), ("match", 7.3, 7.4),
           ("gather", 7.5, 9.5)]
ISSUES = (1.000, 1.020)     # host seconds


def _requests():
    return [types.SimpleNamespace(t_issue=t, t_return=t + 0.010)
            for t in ISSUES]


def _log():
    return [("plan", 0.5, 0.6)] + [
        (n, t + a / 1e3, t + b / 1e3) for t in ISSUES for n, a, b in REQUEST]


def _prof_us(host_s):
    return host_s * 1e6 + OFF_US


def _trace():
    """Busy but for three gaps: in the first request's blocking upload,
    in its `execute` after the gather, and in the harness's `wait`."""
    calls = [("plan_and_call", _prof_us(r.t_issue), _prof_us(r.t_return))
             for r in _requests()]
    ops = [("k", 0, 2000), ("k", 5000, 9650), ("k", 9850, 12000),
           ("k", 15000, 30000)]
    return Trace(ops=ops, spans=calls + [("wait", 10200, 20000)],
                 window=(0, 30000))


@pytest.fixture
def ctx(monkeypatch):
    monkeypatch.setattr(obs, "SPAN_LOG", list(_log()))
    reqs = _requests()
    return types.SimpleNamespace(kind="scan", trace=_trace(),
                                 traced=lambda: reqs, untraced=lambda: [])


def _read(name, ctx):
    return harness.load_reader(ROOT, name)(ctx)


class _Range:
    def __init__(self, a, b):
        self.start, self.end = a, b


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _event(name, device, a, b):
    return types.SimpleNamespace(name=name, device_type=device,
                                 time_range=_Range(a, b))


def test_the_trace_is_the_same_with_the_program_spans_or_without():
    from torch.autograd import DeviceType
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    base = [_event("traced_window", cpu, 0, 100),
            _event("plan_and_call", cpu, 10, 50),
            _event("wait", cpu, 50, 90),
            _event("plan_and_call", cuda, 20, 45),
            _event("k1", cuda, 20, 30), _event("k2", cuda, 35, 45),
            _event("k1", cuda, 60, 70)]
    program = [_event("repro_torch.fetch_block_range", cpu, 11, 49),
               _event("repro_torch.upload", cpu, 12, 25),
               _event("repro_torch.gather", cpu, 40, 48)]
    plain, spanned = from_profiler(_Prof(base)), from_profiler(
        _Prof(base[:3] + program + base[3:]))
    assert spanned.ops == plain.ops and spanned.spans == plain.spans
    assert spanned.busy_s == plain.busy_s and spanned.busy == plain.busy
    assert spanned.gaps() == plain.gaps()
    assert spanned.idle_by_span() == plain.idle_by_span()
    assert spanned.top_ops() == plain.top_ops()
    assert spanned.breakdown() == plain.breakdown()


def test_spans_of_the_traced_calls_only(ctx):
    spans = program_spans.host_spans(ctx)
    assert len(spans) == 2 * len(REQUEST)
    assert all(s[1] >= ISSUES[0] for s in spans)


def test_idle_is_named_by_the_innermost_program_span(ctx):
    moved = program_spans.on_profiler_clock(ctx, program_spans.host_spans(
        ctx))
    assert moved[0][1] == pytest.approx(_prof_us(ISSUES[0] + 0.0001))
    split = program_spans.idle_by_program_span(ctx.trace, moved)
    assert split == {"repro_torch.upload": pytest.approx(3000e-6),
                     "repro_torch.execute": pytest.approx(200e-6),
                     "wait": pytest.approx(3000e-6)}
    # the harness's own split of the same gaps
    assert ctx.trace.idle_by_span() == {
        "plan_and_call": pytest.approx(3200e-6),
        "wait": pytest.approx(3000e-6)}
    # a gap outside every program span keeps its harness name
    assert program_spans.idle_by_program_span(ctx.trace, []) == \
        ctx.trace.idle_by_span()


def test_each_request_is_moved_onto_its_read_back():
    """Device clock 300 us ahead in the first request, 700 us in the
    second: each request's spans follow its own device-to-host copy."""
    spans = [(n, t * 1e6 + a * 1e3, t * 1e6 + b * 1e3)
             for t in ISSUES for n, a, b in REQUEST]
    cover_ends = [t * 1e6 + 6.9e3 for t in ISSUES]
    ops = [("Memcpy DtoH (Device -> Pinned)", e + d - 5, e + d)
           for e, d in zip(cover_ends, (300, 700))]
    moved = program_spans.on_device_clock(Trace(ops=ops, spans=[],
                                                window=(0, 3e6)), spans)
    shifts = [m[1] - s[1] for m, s in zip(moved, spans)]
    assert shifts == pytest.approx([300] * len(REQUEST)
                                   + [700] * len(REQUEST))
    # no copy near a request: the spans keep the last shift
    assert program_spans.on_device_clock(
        Trace(ops=ops[:1], spans=[], window=(0, 3e6)), spans)[-1][1] == \
        pytest.approx(spans[-1][1] + 300)


def test_spans_that_do_not_pair_with_the_calls_are_not_moved(ctx):
    ctx.trace.spans = ctx.trace.spans[1:]
    assert program_spans.on_profiler_clock(ctx, []) is None


def test_gather_device_time_runs_from_the_match_to_the_next_upload():
    ops = [(HTOD, 0, 1), ("rans_decode_kernel", 2, 5),
           ("lz77_match_kernel_short", 5, 9), ("elementwise", 9, 12),
           ("vectorized_gather_kernel", 12, 20), (HTOD, 21, 22),
           ("elementwise", 22, 24), ("lz77_match_kernel_short", 30, 34),
           ("elementwise", 34, 60)]
    t = Trace(ops=ops, spans=[], window=(0, 50))
    assert program_spans.gather_device_s(t) == pytest.approx(
        (3 + 8 + 16) / 1e6)


@pytest.mark.parametrize("name,want", [
    ("plan_ms.scan", 0.8 + 0.3),
    ("cover_sync_ms.scan", 1.0),
    ("enqueue_ms.scan", 4.0 + 0.1 + 0.2 + 0.1 + 2.0),
])
def test_span_readers(ctx, name, want):
    assert _read(name, ctx) == pytest.approx(want)


def test_gather_device_reader(ctx):
    ops = [("lz77_match_kernel_short", 0, 10), ("gather", 10, 40),
           (HTOD, 40, 41), ("lz77_match_kernel_short", 41, 50),
           ("gather", 50, 70)]
    ctx.trace = Trace(ops=ops, spans=ctx.trace.spans, window=(0, 100))
    assert _read("gather_device_ms.scan", ctx) == pytest.approx(
        (30 + 20) / 1e3 / 2)


@pytest.mark.parametrize("name,counts,want", [
    ("decode_amplification.scan", {"blocks.decoded": 48,
                                   "blocks.covered": 32}, 1.5),
    ("host_syncs_per_request.scan", {"host_syncs": 60, "requests": 10},
     6.0),
])
def test_counter_readers(ctx, monkeypatch, name, counts, want):
    for k, v in counts.items():
        monkeypatch.setitem(obs.COUNTS, k, v)
    assert _read(name, ctx) == pytest.approx(want)


NEW = ("plan_ms.scan", "cover_sync_ms.scan", "enqueue_ms.scan",
       "gather_device_ms.scan", "decode_amplification.scan",
       "host_syncs_per_request.scan")


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_without_the_program(ctx, monkeypatch, name):
    """A program without `repro_torch.obs`, as before these readers."""
    import repro_torch
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert _read(name, ctx) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_where_there_is_nothing(ctx, monkeypatch, name):
    monkeypatch.setattr(obs, "SPAN_LOG", [])
    for k in obs.COUNTS:
        monkeypatch.setitem(obs.COUNTS, k, 0)
    assert _read(name, ctx) is None
    ctx.kind = "reads"
    monkeypatch.setattr(obs, "SPAN_LOG", list(_log()))
    assert _read(name, ctx) is None


def test_every_new_reader_is_an_entry_of_the_cell():
    import json
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        assert entries[name]["workloads"] == ["err194147-ra16k.scan"]
        assert entries[name]["moves"] == "scan_GBps"
        assert (ROOT / "portbench" / "metrics" / f"{name}.py").exists()
