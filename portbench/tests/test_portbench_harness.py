"""The harness rehearsed on the CPU at a tiny size: each cell's inputs
and traffic loop against the port with `device="cpu"`, the check held
against planted faults and the control, the trace's interval arithmetic,
and the roofline counts at a small archive."""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import control, harness, roofline  # noqa: E402
from portbench.trace import Trace, union  # noqa: E402

SCAN = "err194147-ra16k.scan"
SEED = 2**31 + 17
_HOSTS = {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(workload=SCAN, tiles=4, tile_blocks=3, request_blocks=4):
    """The cell at a rehearsal size: a tile of `tile_blocks` blocks tiled
    `tiles` times, short scan ranges that a tile does not divide. The
    widths (block size, read length) stay."""
    cell = harness.load_cell(ROOT, workload)
    cfg = dict(cell.config, tiles=tiles, tile_blocks=tile_blocks)
    cfg["raw_bytes"] = tiles * tile_blocks * int(cfg["block_size"])
    traffic = dict(cell.traffic, request_blocks=request_blocks)
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


def host_of(cell, seed=SEED):
    """The host half of set-up from the worker, once per configuration
    and seed."""
    key = (json.dumps(cell.config, sort_keys=True), seed)
    if key not in _HOSTS:
        worker = harness.HostSetup(ROOT, cell.config, seed)
        try:
            _HOSTS[key] = worker.result(timeout=120)
        finally:
            worker.stop()
    return _HOSTS[key]


@pytest.mark.parametrize("tiles,tile_blocks,request_blocks",
                         [(4, 3, 4), (2, 5, 7)])
def test_rehearsal_runs_the_cell_and_checks_it(tiles, tile_blocks,
                                               request_blocks):
    cell = tiny(SCAN, tiles, tile_blocks, request_blocks)
    res = harness.run(ROOT, SCAN, SEED, 0.3, False, host_of(cell),
                      device="cpu", cell=cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checked_requests"] >= 1
    assert list(res)[-1] == "checks"
    assert res["checks"] == {"wrong_bytes": {"value": 0, "limit": 0}}
    assert res["missing_requests"] == 0
    assert set(res["metrics"]) == {"setup_s", "scan_GBps"}


def test_host_setup_worker_returns_the_host_half():
    cell = tiny()
    tile, a, parts = host_of(cell)
    tile2, a2, _ = harness.host_setup(cell.config, SEED)
    assert tile == tile2 and np.array_equal(a.words, a2.words)
    assert len(tile) == a.raw_size == 3 * cell.config["block_size"]
    assert set(parts) == {"generate", "encode"}


def _session(cell):
    sess = harness.prepare(cell, SEED, host_of(cell), device="cpu")
    harness.warm(sess, 2)
    return sess


def _verdict(sess):
    """Check a window that kept two requests or more (a stale answer is
    right for the first), lengthened while a loaded machine keeps fewer."""
    seconds = 0.2
    win = harness.run_window(sess, seconds)
    while len(win.kept) < 2 and seconds < 10:
        seconds *= 2
        win = harness.run_window(sess, seconds)
    checks, wrong = harness.check(sess, win)
    return harness.correct(checks, len(win.kept), win.missing), checks, wrong


def _half_left_out(monkeypatch):
    from repro_torch.core import residency
    gather = residency._gather_reads_core

    def half(*a, **k):
        out = gather(*a, **k)
        out[out.shape[0] // 2:] = 0
        return out
    monkeypatch.setattr(residency, "_gather_reads_core", half)


def _altered_where_produced(monkeypatch):
    from repro_torch.core import residency
    decode = residency._decode_sel_core

    def altered(*a, **k):
        rows = decode(*a, **k)
        rows[0] ^= 1
        return rows
    monkeypatch.setattr(residency, "_decode_sel_core", altered)


def _shifted(sess):
    """Another range's bytes: every range read one block later, or one
    earlier at the archive's end."""
    call = sess.call
    n = sess.reference.n_blocks

    def shifted(spec):
        d = 1 if spec[1] < n else -1
        return call((spec[0] + d, spec[1] + d))
    sess.call = shifted


def _stale_answer(sess):
    call = sess.call
    last = []

    def stale(spec):
        if not last:
            last.append(call(spec))
        return last[0]
    sess.call = stale


@pytest.mark.parametrize("fault", ["half", "altered", "stale", "shifted"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    sess = _session(tiny())
    if fault == "half":
        _half_left_out(monkeypatch)
    elif fault == "altered":
        _altered_where_produced(monkeypatch)
    elif fault == "shifted":
        _shifted(sess)
    else:
        _stale_answer(sess)
    ok, checks, wrong = _verdict(sess)
    assert not ok and wrong > 0 and checks["wrong_bytes"]["value"] > 0


def test_the_control_is_not_correct():
    sess = _session(tiny(tiles=2, tile_blocks=15, request_blocks=8))
    assert _verdict(sess)[0]
    control.fewer_rounds(sess.store)
    ok, checks, _ = _verdict(sess)
    assert not ok and checks["wrong_bytes"]["value"] > 0


def test_union_gaps_and_idle_named_by_host_span():
    assert union([(5, 7), (0, 2), (1, 3), (7, 8), (9, 9)]) == [(0, 3),
                                                                (5, 8)]
    t = Trace(ops=[("k1", 0, 2), ("k2", 1, 3), ("k1", 5, 8), ("k3", 9, 12)],
              spans=[("plan_and_call", 2.5, 4.5), ("wait", 4.5, 9.5)],
              window=(1, 10))
    assert t.busy == [(1, 3), (5, 8), (9, 10)]
    assert t.gaps() == [(3, 5), (8, 9)]
    assert t.busy_s == pytest.approx(6e-6) and t.window_s == pytest.approx(
        9e-6)
    assert t.idle_by_span() == {"plan_and_call": pytest.approx(2e-6),
                                "wait": pytest.approx(1e-6)}
    assert t.kernel("k1") == (2, pytest.approx(4e-6))
    assert t.breakdown()["device_ops"][0][0] == "k1"


def test_roofline_counts_at_a_small_archive():
    from repro_torch.core.decoder import to_device
    from repro_torch.core.encoder import encode
    from repro_torch.data.tiling import tile_archive
    from portbench.reference.fastq import aligned_tile
    bs = 16384
    tile, _ = aligned_tile(harness.load_cell(ROOT, SCAN).config, 4, bs,
                           np.random.default_rng(4))
    a = encode(tile, block_size=bs)
    per = roofline.block_work(a.lanes, a.n_syms, a.n_words, a.n_cmds, bs,
                              a.offset_bytes)
    work = roofline.RangeWork(per, a.n_blocks)
    t = tile_archive(a, 4)
    da = to_device(t, "cpu")
    assert roofline.stream_row_bytes(bs, da.max_cmds,
                                     da.offset_bytes) == da.layout.row
    b0, b1 = 3, 13                      # across tile edges
    sel = np.arange(b0, b1)
    lanes = np.maximum(t.lanes[sel].astype(np.int64), 1)
    nsym = t.n_syms[sel].astype(np.int64)
    rans_bytes = (2 * int((2 * lanes + t.n_words[sel]).sum())
                  + nsym.size * 16 + 4 * 4096 * 4 + sel.size * da.layout.row)
    lz_bytes = ((4 + t.offset_bytes) * int(t.n_cmds[sel].sum())
                + int(nsym[:, 0].sum()) + 8 * sel.size + sel.size * bs)
    w = work.of_range(b0, b1)
    assert w["rans_bytes"] == rans_bytes and w["lz77_bytes"] == lz_bytes
    assert w["lz77_ops"] == 2 * bs * sel.size
    assert w["compressed"] == 2 * int(t.n_words[sel].sum())
    assert w["raw"] == bs * sel.size
    assert roofline.bound_s(w["rans_bytes"], w["rans_ops"]) > 0
