"""The port's encode autotuner against the JAX reference on the CPU:
`EncodeProfile`, grid validation, the Pareto frontier, objective
selection, `encode(profile=)`, `GenomicArchive.create` and the trainer's
`--tune-target`.

The reference's `tests/test_tune.py` is mirrored case for case on port
archives (same corpus, 128 KiB samples, `iters=1`, `device="cpu"`).
Parity with the reference: equal grid splits and skip reasons,
byte-equal archives for every point of the default grid (so equal
ratios), equal frontiers and selections on equal measurements, and the
same selected profile when both packages' `measure_point` is replaced by
one deterministic function of the profile. Seek and decode times are
readings of this machine and are not compared.
"""
import importlib
import logging

import numpy as np
import pytest
import torch

from repro.api import GenomicArchive as RGA
from repro.core.encoder import encode as r_encode
from repro.core.format import serialize as r_serialize
from repro.tune import EncodeProfile as REncodeProfile
from repro.tune import TunePoint as RTunePoint
from repro.tune import pareto_frontier as r_pareto_frontier
from repro.tune import validate_grid as r_validate_grid
from repro_torch.api import GenomicArchive
from repro_torch.core.decoder import Decoder
from repro_torch.core.encoder import encode, validate_encode_params
from repro_torch.core.format import serialize
from repro_torch.data.fastq import make_fastq
from repro_torch.tune import (EncodeProfile, TunePoint, autotune,
                              default_grid, pareto_frontier, time_fn,
                              validate_grid)

# the packages export the function `autotune` under the module's name
r_autotune_mod = importlib.import_module("repro.tune.autotune")
p_autotune_mod = importlib.import_module("repro_torch.tune.autotune")

CORPUS = make_fastq("platinum", n_reads=800, seed=5)
SAMPLE = CORPUS[:128 * 1024]


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -------------------------------------------------------------- profile
def test_profile_defaults_and_describe():
    p = EncodeProfile()
    assert p.block_size == 16 * 1024 and p.mode == "ra"
    assert p.offset_bytes == 2
    assert p.describe() == "ra/rans/block=16384/off=2B"
    assert p.encode_kwargs() == dict(block_size=16 * 1024, mode="ra",
                                     entropy="rans", anchor_interval=0)
    # describe() lands in CSV fields: the same strings as the reference's
    for pt in default_grid():
        assert EncodeProfile(**pt).describe() == \
            REncodeProfile(**pt).describe()
        assert EncodeProfile(**pt).offset_bytes == \
            REncodeProfile(**pt).offset_bytes


def test_profile_offset_bytes_regimes():
    assert EncodeProfile(block_size=64 * 1024).offset_bytes == 4
    assert EncodeProfile(block_size=0xFFFF).offset_bytes == 2
    assert EncodeProfile(mode="global", anchor_interval=4).offset_bytes == 8


def test_profile_validates_knobs_up_front():
    with pytest.raises(ValueError, match="anchor_interval"):
        EncodeProfile(mode="ra", anchor_interval=4)
    with pytest.raises(ValueError, match="block_size"):
        EncodeProfile(block_size=0)
    with pytest.raises(ValueError, match="entropy"):
        EncodeProfile(entropy="zstd")
    with pytest.raises(ValueError, match="mode"):
        EncodeProfile(mode="local")
    with pytest.raises(AttributeError):
        EncodeProfile().block_size = 4096          # frozen


def test_validate_encode_params_window_guard():
    with pytest.raises(ValueError, match="2 GiB|anchor_interval"):
        validate_encode_params(1 << 20, "global", "rans", 1 << 12)
    validate_encode_params(16 * 1024, "global", "rans", 4)


# ------------------------------------------------------- encode(profile=)
def test_encode_accepts_profile():
    prof = EncodeProfile(block_size=4096, entropy="raw")
    a = encode(CORPUS, profile=prof)
    assert a.block_size == 4096 and a.entropy == "raw"
    d = Decoder(a, device="cpu")
    assert d.decode_all().tobytes() == CORPUS


def test_encode_rejects_profile_plus_explicit_knobs():
    prof = EncodeProfile(block_size=4096)
    with pytest.raises(ValueError, match="profile"):
        encode(CORPUS, block_size=8192, profile=prof)
    with pytest.raises(ValueError, match="profile"):
        encode(CORPUS, entropy="raw", profile=prof)


@pytest.mark.parametrize("point", default_grid(),
                         ids=lambda pt: EncodeProfile(**pt).describe())
def test_profile_archives_byte_equal_to_the_reference(point):
    """Every point of the default grid on a 128 KiB sample: the same
    archive bytes from both packages, so the same ratio."""
    got = encode(SAMPLE, profile=EncodeProfile(**point))
    want = r_encode(SAMPLE, profile=REncodeProfile(**point))
    assert serialize(got) == r_serialize(want)
    assert got.ratio == want.ratio


# ------------------------------------------------------------------ grid
def test_default_grid_shape():
    grid = default_grid()
    assert len(grid) == 8                      # 2 blocks × 2 anchors × 2 ent
    for pt in grid:
        assert pt["mode"] == ("global" if pt["anchor_interval"] else "ra")
    assert grid == r_autotune_mod.default_grid()


def test_validate_grid_skips_invalid_with_reason(caplog):
    grid = [dict(block_size=4096, mode="ra", entropy="rans",
                 anchor_interval=0),
            dict(block_size=4096, mode="ra", entropy="rans",
                 anchor_interval=4),            # anchors need global
            dict(block_size=4096, mode="ra", entropy="zstd",
                 anchor_interval=0),            # unknown entropy
            dict(block_size=1 << 20, mode="global", entropy="rans",
                 anchor_interval=1 << 12),      # a 4 GiB anchor window
            dict(block_size=4096, mode="global", entropy="raw",
                 anchor_interval=0)]            # anchor-free past 2 GiB
    with caplog.at_level(logging.INFO, logger="repro_torch.tune"):
        valid, skipped = validate_grid(grid, raw_size=100_000)
    assert valid == [grid[0], grid[4]]
    assert len(skipped) == 3
    assert all(reason for _, reason in skipped)
    assert sum("skipping grid point" in r.message
               for r in caplog.records) == 3
    # the reference's split and reasons, also past the 2 GiB horizon
    for raw in (100_000, 2 ** 31):
        assert validate_grid(grid, raw) == r_validate_grid(grid, raw)


# -------------------------------------------------------------- frontier
def _pt(ratio, seek, gbps):
    return TunePoint(profile=EncodeProfile(), ratio=ratio, seek_us=seek,
                     decode_GBps=gbps)


def test_pareto_frontier_drops_dominated():
    a = _pt(3.0, 100, 1.0)     # best ratio
    b = _pt(2.0, 50, 2.0)      # best seek + throughput
    c = _pt(1.5, 200, 0.5)     # dominated by both
    front = pareto_frontier([a, b, c])
    assert a in front and b in front and c not in front
    assert a.on_frontier and b.on_frontier and not c.on_frontier


def test_frontier_and_selection_match_the_reference():
    """Identical hand-built points (ties included) in both packages: the
    same frontier, and the same selection for every target and for seek
    budgets below, inside and above the measured range."""
    rng = np.random.default_rng(7)
    grid = default_grid(block_sizes=(4096, 16384, 65536))
    vals = [(float(rng.choice([2.0, 2.5, 3.0, 3.5])),
             float(rng.integers(20, 200)), float(rng.choice([0.5, 1.0])))
            for _ in grid]
    mine = [TunePoint(EncodeProfile(**g), *v) for g, v in zip(grid, vals)]
    theirs = [RTunePoint(REncodeProfile(**g), *v)
              for g, v in zip(grid, vals)]
    front = pareto_frontier(mine)
    rfront = r_pareto_frontier(theirs)
    assert [mine.index(p) for p in front] == \
        [theirs.index(p) for p in rfront]
    assert [p.on_frontier for p in mine] == [p.on_frontier for p in theirs]
    for target in ("seek", "ratio", "throughput"):
        for budget in (None, 1.0, 100.0, 1e9):
            got = p_autotune_mod._select(front, target, budget)
            want = r_autotune_mod._select(rfront, target, budget)
            assert front.index(got) == rfront.index(want), (target, budget)
    with pytest.raises(ValueError, match="target"):
        p_autotune_mod._select(front, "vibes", None)


def _fixed_measure(archive, decoder, sample_bytes, iters=3):
    """One deterministic function of the profile (and the real ratio,
    equal in both packages): no machine reading in it."""
    b = archive.block_size // 1024
    raw = archive.entropy == "raw"
    anc = archive.anchor_interval
    return {"ratio": float(archive.ratio),
            "seek_us": 10.0 * b + (5.0 if raw else 9.0) + 3.0 * anc,
            "decode_GBps": 0.1 * b + (0.7 if raw else 0.2) - 0.05 * anc}


@pytest.mark.parametrize("target,budget", [("seek", None), ("ratio", None),
                                           ("throughput", None),
                                           ("seek", 200.0)])
def test_autotune_selects_the_reference_profile_on_fixed_measurements(
        monkeypatch, target, budget):
    monkeypatch.setattr(p_autotune_mod, "measure_point", _fixed_measure)
    monkeypatch.setattr(r_autotune_mod, "measure_point", _fixed_measure)
    sample = CORPUS[:32 * 1024]
    got = autotune(sample, target=target, latency_budget_us=budget,
                   iters=1, device="cpu")
    want = r_autotune_mod.autotune(sample, target=target,
                                   latency_budget_us=budget, iters=1)
    assert got.profile.encode_kwargs() == want.profile.encode_kwargs()
    assert [(p.profile.encode_kwargs(), p.ratio, p.seek_us, p.decode_GBps,
             p.on_frontier) for p in got.points] == \
        [(p.profile.encode_kwargs(), p.ratio, p.seek_us, p.decode_GBps,
          p.on_frontier) for p in want.points]
    assert got.table() == want.table()


# ----------------------------------------------------------------- sweep
@pytest.fixture(scope="module")
def tuned():
    grid = default_grid(block_sizes=(4096, 16 * 1024),
                        anchor_intervals=(0, 4), entropies=("rans", "raw"))
    return autotune(CORPUS, target="seek", grid=grid,
                    sample_bytes=128 * 1024, iters=1, device="cpu")


def test_autotune_sweeps_and_selects(tuned):
    assert len(tuned.points) == 8 and not tuned.skipped
    assert tuned.frontier and tuned.profile in [p.profile
                                                for p in tuned.frontier]
    # the selected point is the frontier's fastest seek
    assert tuned.profile == min(tuned.frontier,
                                key=lambda p: p.seek_us).profile
    assert tuned.sample_bytes <= 128 * 1024
    # frontier table renders one row per frontier point
    table = tuned.table()
    assert table.count("\n") == len(tuned.frontier) + 1
    # each point's ratio is the reference's for the same profile
    for p in tuned.points:
        want = r_encode(CORPUS[:128 * 1024],
                        profile=REncodeProfile(**p.profile.encode_kwargs()))
        assert p.ratio == want.ratio


def test_autotune_ratio_target(tuned):
    r = autotune(CORPUS, target="ratio",
                 grid=[p.profile.encode_kwargs() for p in tuned.points],
                 sample_bytes=128 * 1024, iters=1, device="cpu")
    assert r.profile == max(r.frontier, key=lambda p: p.ratio).profile


def test_autotune_latency_budget(tuned):
    # a budget every point fits selects the best-ratio point on the
    # frontier (the reference's test takes the first sweep's slowest seek
    # plus 1 µs, which a second sweep's readings may exceed)
    r = autotune(CORPUS, target="seek", latency_budget_us=1e12,
                 grid=[p.profile.encode_kwargs() for p in tuned.frontier],
                 sample_bytes=128 * 1024, iters=1, device="cpu")
    assert r.profile == max(r.frontier, key=lambda p: p.ratio).profile


def test_autotune_rejects_bad_target():
    with pytest.raises(ValueError, match="target"):
        autotune(CORPUS, target="vibes", sample_bytes=4096, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        autotune(b"", sample_bytes=4096, device="cpu")


def test_autotune_all_invalid_grid_raises():
    bad = [dict(block_size=4096, mode="ra", entropy="rans",
                anchor_interval=9)]
    with pytest.raises(ValueError, match="invalid"):
        autotune(CORPUS, grid=bad, sample_bytes=4096, device="cpu")


def test_time_fn_is_best_of_n_after_warmup():
    calls = []
    t = time_fn(lambda x: calls.append(x) or torch.zeros(1), 7, warmup=2,
                iters=3)
    assert calls == [7] * 5 and 0.0 <= t < 1.0


# ------------------------------------------------------------- archive api
def test_genomic_archive_create_tunes_and_decodes(tuned):
    ga = GenomicArchive.create(CORPUS, profile=tuned.profile, device="cpu")
    assert ga.profile == tuned.profile
    assert ga.block_size == tuned.profile.block_size
    lo = 1000
    ref = np.frombuffer(CORPUS, np.uint8)
    assert np.array_equal(ga[lo:lo + 500], ref[lo:lo + 500])


def test_genomic_archive_create_sweeps_when_no_profile():
    small = make_fastq("platinum", n_reads=200, seed=6)
    ga = GenomicArchive.create(small, target="seek",
                               sample_bytes=32 * 1024,
                               grid=default_grid(block_sizes=(4096,),
                                                 anchor_intervals=(0,)),
                               iters=1, device="cpu")
    assert ga.profile is not None and ga.profile.block_size == 4096
    assert ga.store.decoder.decode_all().tobytes() == small


@pytest.mark.parametrize("record_bytes", [None, 129])
def test_create_with_a_profile_decodes_and_saves_like_the_reference(
        tmp_path, record_bytes):
    """`create(profile=...)` in both packages: both decode the corpus, and
    the saved containers are byte-equal and open in the other package."""
    corpus = make_fastq("platinum", n_reads=200, seed=6)
    pt = dict(block_size=4096, mode="global", entropy="rans",
              anchor_interval=4)
    ga = GenomicArchive.create(corpus, profile=EncodeProfile(**pt),
                               record_bytes=record_bytes, device="cpu")
    rga = RGA.create(corpus, profile=REncodeProfile(**pt),
                     record_bytes=record_bytes, backend="ref")
    n = len(corpus) - len(corpus) % (record_bytes or 1)
    assert ga.store.decoder.decode_all().tobytes() == corpus[:n]
    assert bytes(np.asarray(rga.store.decoder.decode_all())) == corpus[:n]
    mine, theirs = str(tmp_path / "p.acegad"), str(tmp_path / "r.acegad")
    ga.save(mine)
    rga.save(theirs)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    back = GenomicArchive.open(theirs, device="cpu")
    assert back.store.decoder.decode_all().tobytes() == corpus[:n]
    assert back.block_size == 4096
    assert bytes(np.asarray(RGA.open(mine).store.decoder.decode_all())) \
        == corpus[:n]


# ---------------------------------------------------------------- trainer
def test_train_launcher_tune_target_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    archive = str(tmp_path / "c.acegad")
    train.main(["--device", "cpu", "--reduced", "--steps", "2", "--batch",
                "2", "--seq", "32", "--reads", "150", "--prefetch", "0",
                "--tune-target", "ratio", "--archive", archive,
                "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "autotuned profile:" in out and "saved archive" in out
    assert "training complete; 2" in out
    ga = GenomicArchive.open(archive, device="cpu")
    # the ratio target picks the grid's best ratio, a function of the
    # archive bytes alone (the best ratio is never dominated)
    corpus = make_fastq("platinum", n_reads=150, seed=0)
    best = max(default_grid(), key=lambda pt: encode(corpus, **pt).ratio)
    assert ga.block_size == best["block_size"]
    assert ga.store.decoder.archive.mode == best["mode"]
    assert ga.store.decoder.archive.entropy == best["entropy"]
