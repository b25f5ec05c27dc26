"""The port's async compressed-resident data plane against the reference.

Mirrors `tests/test_prefetch.py` on port archives (`device="cpu"`):
prefetch determinism, restart, backpressure, shutdown and the loader
shim (its two `run_resilient_training` tests are mirrored in
`test_torch_fault_tolerance.py`). Then holds the port's `ArchiveDataset`
against the reference's on archives of the same corpus: token batches,
windows and `state_dict` payloads bit for bit, payloads loaded across
packages, and the decode counters after a batch. Thread handshakes use
events and queues; where a test needs the worker to have reached a
state (blocked on a full queue), it waits for that condition, never for
a duration.
"""
import json
import queue
import threading

import numpy as np
import pytest
import torch

from repro.api.archive import GenomicArchive as RArchive
from repro.data.prefetch import AsyncPrefetcher as RPrefetcher
from repro_torch.api.archive import GenomicArchive
from repro_torch.api.dataset import (ArchiveDataset, SequentialSampler,
                                     UniformSampler, make_sampler)
from repro_torch.data.fastq import make_fastq
from repro_torch.data.pipeline import (CompressedResidentDataLoader,
                                       PipelineConfig)
from repro_torch.data.prefetch import (AsyncPrefetcher, PrefetchingLoader,
                                       PrefetchWorkerError)
from repro_torch.data.tokenizer import PAD_ID, decode_bytes, encode_bytes


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _until(cond, what: str, limit_s: float = 60.0) -> None:
    """Wait until `cond()` holds (a state the worker reaches after a few
    instructions); the limit only turns a hang into a failure."""
    ev = threading.Event()
    for _ in range(int(limit_s / 0.001)):
        if cond():
            return
        ev.wait(0.001)
    raise AssertionError(f"never reached: {what}")


@pytest.fixture(scope="module")
def corpus():
    return make_fastq("platinum", n_reads=600, seed=7)


@pytest.fixture(scope="module")
def archive(corpus):
    return GenomicArchive.from_records(corpus, record_bytes=33,
                                       block_size=4096, device="cpu")


@pytest.fixture(scope="module")
def r_archive(corpus):
    return RArchive.from_records(corpus, record_bytes=33, block_size=4096,
                                 backend="ref")


def _take(ds, n):
    it = iter(ds)
    return [next(it)["tokens"].numpy() for _ in range(n)]


# ----------------------------------------------------------- determinism
def test_sync_vs_prefetch_bit_identity_any_depth(archive):
    ds = archive.dataset(batch_size=4, seq_len=32, prefetch=0, seed=3)
    ref = _take(ds, 6)
    ds.close()
    for depth in (1, 2, 5):
        d = archive.dataset(batch_size=4, seq_len=32, prefetch=depth, seed=3)
        got = _take(d, 6)
        d.close()
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)


def test_windows_stack_the_per_step_stream(archive):
    ds = archive.dataset(batch_size=4, seq_len=32, prefetch=0, seed=1)
    ref = _take(ds, 6)
    ds.close()
    dw = archive.dataset(batch_size=4, seq_len=32, prefetch=2, seed=1)
    wit = dw.windows(3)
    wins = [next(wit) for _ in range(2)]
    dw.close()
    got = [w["tokens"][i].numpy() for w in wins for i in range(3)]
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    assert tuple(wins[0]["tokens"].shape) == (3, 4, 32)


def test_restart_mid_prefetch_determinism(archive):
    ds = archive.dataset(batch_size=4, seq_len=32, prefetch=3, seed=11)
    it = iter(ds)
    for _ in range(4):
        next(it)
    st = ds.state_dict()
    assert st["step"] == 4
    later = [next(it)["tokens"].numpy() for _ in range(3)]

    ds.load_state_dict(st)                      # same instance
    for a, b in zip(later, _take(ds, 3)):
        np.testing.assert_array_equal(a, b)
    ds.close()

    fresh = archive.dataset(batch_size=4, seq_len=32, prefetch=1, seed=0)
    fresh.load_state_dict(st)                   # fresh instance, new depth
    for a, b in zip(later, _take(fresh, 3)):
        np.testing.assert_array_equal(a, b)
    fresh.close()


def test_state_dict_survives_json_and_legacy_payload(archive):
    ds = archive.dataset(batch_size=2, seq_len=32, prefetch=2, seed=5)
    ref = _take(ds, 3)
    st = json.loads(json.dumps(ds.state_dict()))   # checkpoint manifest trip
    ds.close()
    d2 = archive.dataset(batch_size=2, seq_len=32, prefetch=0)
    d2.load_state_dict(st)
    assert d2.step == 3 and d2.sampler.seed == 5
    d3 = archive.dataset(batch_size=2, seq_len=32, prefetch=0)
    d3.load_state_dict({"step": 0, "seed": 5})
    for a, b in zip(ref, _take(d3, 3)):
        np.testing.assert_array_equal(a, b)
    d3.close()


def test_sequential_sampler_epochs(archive):
    ds = archive.dataset(batch_size=4, seq_len=32, sampler="sequential",
                         prefetch=0)
    np.testing.assert_array_equal(ds.sampler.sample(0), np.arange(4))
    wrap = ds.sampler.sample(ds.n_records)   # wraps, never out of range
    assert (wrap < ds.n_records).all()
    assert isinstance(ds.sampler, SequentialSampler)


# ---------------------------------------------------------- backpressure
def test_bounded_queue_backpressure():
    """A fast producer never runs more than depth+1 items ahead of the
    consumer (depth queued + one awaiting put) and records its stalls."""
    depth = 2
    pf = AsyncPrefetcher(lambda s: s * s, depth=depth)
    _until(lambda: pf.stalls > 0, "the producer blocked on a full queue")
    assert pf.produced - pf.consumed == depth + 1
    got = []
    for i in range(8):
        step, item = pf.get(timeout=30)
        got.append((step, item))
        assert pf.produced - pf.consumed <= depth + 1
    pf.stop()
    assert got == [(i, i * i) for i in range(8)]
    assert pf.max_ahead <= depth + 1
    assert pf.stalls > 0


def test_prefetch_stride():
    pf = AsyncPrefetcher(lambda s: s, start_step=10, depth=2, stride=4)
    steps = [pf.get(timeout=30)[0] for _ in range(3)]
    pf.stop()
    assert steps == [10, 14, 18]


# -------------------------------------------------------------- shutdown
def test_shutdown_without_leaked_workers(archive):
    n0 = threading.active_count()
    ds = archive.dataset(batch_size=2, seq_len=32, prefetch=2)
    it = iter(ds)
    next(it)
    assert threading.active_count() > n0     # worker actually running
    ds.close()
    assert threading.active_count() == n0
    ds.close()                               # idempotent
    it_b = iter(ds)
    next(it_b)
    assert threading.active_count() > n0
    del it_b                                 # the generator's finally reaps
    assert threading.active_count() == n0
    it1 = iter(ds)
    next(it1)
    it2 = iter(ds)                           # replaces the first worker
    next(it2)
    assert threading.active_count() == n0 + 1
    ds.close()
    assert threading.active_count() == n0


def test_shutdown_unblocks_stalled_producer():
    pf = AsyncPrefetcher(lambda s: s, depth=1)
    _until(lambda: pf.stalls > 0, "the producer blocked on put")
    assert pf.alive
    pf.stop()
    assert not pf.alive


def test_context_managers():
    n0 = threading.active_count()
    with PrefetchingLoader(lambda s: s, depth=2) as pl:
        assert next(pl) == 0 and next(pl) == 1
    assert threading.active_count() == n0


def test_worker_exception_propagates():
    def boom(step):
        if step == 2:
            raise ValueError("bad decode")
        return step

    pl = PrefetchingLoader(boom, depth=2)
    assert next(pl) == 0 and next(pl) == 1
    with pytest.raises(PrefetchWorkerError, match="bad decode"):
        for _ in range(4):
            next(pl)
    pl.close()


def test_ready_hook_runs_on_the_worker_before_delivery():
    seen = queue.Queue()
    main = threading.get_ident()

    def ready(item):
        seen.put((item, threading.get_ident() != main))

    pf = AsyncPrefetcher(lambda s: s + 100, depth=2, ready=ready)
    step, item = pf.get(timeout=30)
    pf.stop()
    assert (step, item) == (0, 100)
    assert seen.get_nowait() == (100, True)


# ------------------------------------------------- legacy shim redesign
def test_legacy_shim_is_a_dataset_shim(corpus, archive):
    dl = CompressedResidentDataLoader(
        corpus, PipelineConfig(seq_len=32, batch_size=4, block_size=4096,
                               seed=3), device="cpu")
    ds = archive.dataset(batch_size=4, seq_len=32, prefetch=0, seed=3)
    it_dl, it_ds = iter(dl), iter(ds)
    for _ in range(4):
        assert torch.equal(next(it_dl)["tokens"], next(it_ds)["tokens"])
    st = dl.state_dict()
    cont_dl = [next(it_dl)["tokens"].numpy() for _ in range(3)]
    d2 = archive.dataset(batch_size=4, seq_len=32, prefetch=2)
    d2.load_state_dict(st)
    for a, b in zip(cont_dl, _take(d2, 3)):
        np.testing.assert_array_equal(a, b)
    st2 = d2.state_dict()
    cont_ds = _take(d2, 2)
    d2.close()
    dl.load_state_dict(st2)
    it3 = iter(dl)
    for a in cont_ds:
        np.testing.assert_array_equal(a, next(it3)["tokens"].numpy())
    dl.close()


def test_shim_fetch_rides_query_plane_and_cache(corpus):
    dl = CompressedResidentDataLoader(
        corpus, PipelineConfig(seq_len=32, batch_size=4, block_size=4096,
                               cache_blocks=8), device="cpu")
    ids = np.arange(4)
    a = dl.fetch(ids)
    b = dl.fetch(ids)
    assert torch.equal(a["tokens"], b["tokens"])
    assert dl.archive.cache_info()["hits"] > 0
    dl.close()


# ------------------------------------------------------- archive on disk
def test_archive_save_open_roundtrip(tmp_path, corpus, archive):
    p = str(tmp_path / "corpus.acegad")
    archive.save(p)
    ga2 = GenomicArchive.open(p, device="cpu")
    ds1 = archive.dataset(batch_size=4, seq_len=32, prefetch=0, seed=2)
    ds2 = ga2.dataset(batch_size=4, seq_len=32, prefetch=0, seed=2)
    for a, b in zip(_take(ds1, 3), _take(ds2, 3)):
        np.testing.assert_array_equal(a, b)
    ga3 = GenomicArchive.from_bytes(corpus, block_size=4096, device="cpu")
    p2 = str(tmp_path / "named.acegad")
    ga3.save(p2)
    ga4 = GenomicArchive.open(p2, device="cpu")
    np.testing.assert_array_equal(ga3[5], ga4[5])
    name = ga3._raw_names[9].decode()
    np.testing.assert_array_equal(ga3[name], ga4[name])


def test_open_rejects_garbage(tmp_path):
    p = str(tmp_path / "junk.bin")
    with open(p, "wb") as f:
        f.write(b"NOTANARCHIVE" * 4)
    with pytest.raises(ValueError, match="magic"):
        GenomicArchive.open(p, device="cpu")


# ------------------------------------------- the port against the reference
def _r_take(ds, n):
    it = iter(ds)
    return [np.asarray(next(it)["tokens"]) for _ in range(n)]


@pytest.mark.parametrize("sampler", ["uniform", "sequential"])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_batches_windows_and_state_equal_the_reference(archive, r_archive,
                                                       sampler, prefetch):
    kw = dict(batch_size=4, seq_len=32, sampler=sampler, seed=9)
    ds = archive.dataset(prefetch=prefetch, **kw)
    rds = r_archive.dataset(prefetch=prefetch, **kw)
    it, rit = iter(ds), iter(rds)
    for _ in range(5):
        b, rb = next(it), next(rit)
        for k in ("tokens", "labels"):
            assert b[k].dtype == torch.int32
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(rb[k]))
    st, rst = ds.state_dict(), rds.state_dict()
    st.pop("in_flight", None), rst.pop("in_flight", None)
    assert st == rst
    ds.close(), rds.close()
    w, rw = next(ds.windows(3)), next(rds.windows(3))
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(w[k].numpy(), np.asarray(rw[k]))
    ds.close(), rds.close()
    assert ds.state_dict() == rds.state_dict()
    assert repr(ds) == repr(rds)


def test_state_dicts_load_across_packages(archive, r_archive):
    ds = archive.dataset(batch_size=4, seq_len=32, prefetch=2, seed=21)
    rds = r_archive.dataset(batch_size=4, seq_len=32, prefetch=2, seed=21)
    _take(ds, 3), _r_take(rds, 5)
    port_st = json.loads(json.dumps(ds.state_dict()))
    ref_st = json.loads(json.dumps(rds.state_dict()))
    ds.close(), rds.close()
    # the reference resumes the port's stream, and the port the reference's
    r2 = r_archive.dataset(batch_size=4, seq_len=32, prefetch=0)
    r2.load_state_dict(port_st)
    p2 = archive.dataset(batch_size=4, seq_len=32, prefetch=1)
    p2.load_state_dict(ref_st)
    for a, b in zip(_take(ds, 2), _r_take(r2, 2)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_take(p2, 2), _r_take(rds, 2)):
        np.testing.assert_array_equal(a, b)
    p2.close(), r2.close(), ds.close(), rds.close()


def test_samplers_equal_the_reference():
    from repro.api import dataset as rdataset
    for kind in ("uniform", "sequential"):
        s = make_sampler(kind, 1000, 8, seed=4)
        r = rdataset.make_sampler(kind, 1000, 8, seed=4)
        for step in (0, 1, 125, 10 ** 9):
            np.testing.assert_array_equal(s.sample(step), r.sample(step))
        assert s.state_dict() == r.state_dict()
    assert isinstance(make_sampler({"kind": "uniform", "seed": 2}, 5, 1),
                      UniformSampler)


@pytest.mark.parametrize("cache_blocks", [0, 16])
def test_decode_counters_after_a_batch_equal_the_reference(
        corpus, cache_blocks):
    ga = GenomicArchive.from_records(corpus, record_bytes=33,
                                     block_size=2048, device="cpu",
                                     cache_blocks=cache_blocks)
    rga = RArchive.from_records(corpus, record_bytes=33, block_size=2048,
                                backend="ref", cache_blocks=cache_blocks)
    ds = ga.dataset(batch_size=8, seq_len=32, prefetch=0, seed=6)
    rds = rga.dataset(batch_size=8, seq_len=32, prefetch=0, seed=6)
    for step in range(4):
        np.testing.assert_array_equal(ds.batch_at(step)["tokens"].numpy(),
                                      np.asarray(rds.batch_at(step)
                                                 ["tokens"]))
        assert ga.store.decoder.decoded_blocks_last == \
            rga.store.decoder.decoded_blocks_last
        assert ga.cache_info() == rga.cache_info()
    np.testing.assert_array_equal(ds.window_at(4, 3)["labels"].numpy(),
                                  np.asarray(rds.window_at(4, 3)["labels"]))
    assert ga.store.decoder.decoded_blocks_last == \
        rga.store.decoder.decoded_blocks_last
    assert ga.cache_info() == rga.cache_info()


@pytest.mark.parametrize("seq_len", [100, 400])
def test_variable_length_reads_cut_or_padded_like_the_reference(corpus,
                                                                seq_len):
    ga = GenomicArchive.from_bytes(corpus, block_size=4096, device="cpu")
    rga = RArchive.from_bytes(corpus, block_size=4096, backend="ref")
    with pytest.raises(ValueError, match="seq_len"):
        ga.dataset(batch_size=2)
    ds = ga.dataset(batch_size=6, seq_len=seq_len, prefetch=0, seed=1)
    rds = rga.dataset(batch_size=6, seq_len=seq_len, prefetch=0, seed=1)
    b, rb = ds.batch_at(7), rds.batch_at(7)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(rb[k]))
    # and the source bytes, cut or zero-padded to seq_len + 1
    starts = ga.store.index.starts.astype(np.int64)
    for row, r in zip(ds.fetch_ids(ds.sampler.sample(7)).numpy(),
                      ds.sampler.sample(7)):
        src = corpus[starts[r]:starts[r + 1]][:seq_len + 1]
        want = np.full(seq_len + 1, PAD_ID, np.uint8)
        want[:len(src)] = encode_bytes(src)
        np.testing.assert_array_equal(row, want)
        assert decode_bytes(row[:len(src)]) == src


def test_dataset_needs_an_index():
    from repro_torch.core.encoder import encode
    from repro_torch.core.residency import CompressedResidentStore
    st = CompressedResidentStore(encode(b"ACGT" * 100, block_size=256),
                                 device="cpu")
    with pytest.raises(ValueError, match="indexed"):
        ArchiveDataset(GenomicArchive(st))


# -------------------------------------------------------- worker crashes
def test_prefetch_worker_crash_restarts_bit_exact():
    """The reference's `test_resilience.py` crash test on the port."""
    from repro_torch.core.encoder import encode
    from repro_torch.core.index import ReadIndex
    from repro_torch.core.residency import CompressedResidentStore
    from repro_torch.resilience.faults import FaultInjector, PrefetchCrash
    rng = np.random.default_rng(123)
    data = rng.integers(0, 4, 4096, dtype=np.uint8).tobytes()
    idx = ReadIndex.fixed_records(len(data) // 128, 128, 256)
    st = CompressedResidentStore(encode(data, block_size=256), index=idx,
                                 device="cpu")

    def produce(step):
        ids = np.arange(step % 4, st.index.n_reads, 4)
        return st.fetch_reads(ids)[0].numpy()

    want = [produce(s) for s in range(6)]
    crashy = FaultInjector(seed=51).crashing_producer(produce, at_step=3)
    got, step, crashes = [], 0, 0
    pf = AsyncPrefetcher(crashy, start_step=0, depth=2)
    try:
        while len(got) < 6:
            try:
                s, item = pf.get(timeout=30.0)
            except PrefetchWorkerError as e:
                assert isinstance(e.__cause__, PrefetchCrash)
                crashes += 1
                pf.stop()
                pf = AsyncPrefetcher(crashy, start_step=step, depth=2)
                continue
            assert s == step
            got.append(item)
            step += 1
    finally:
        pf.stop()
    assert crashes == 1
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_prefetcher_stats_equal_the_reference_shape():
    pf, rpf = AsyncPrefetcher(lambda s: s, depth=2), \
        RPrefetcher(lambda s: s, depth=2)
    pf.get(timeout=30), rpf.get(timeout=30)
    pf.stop(), rpf.stop()
    assert set(pf.stats()) == set(rpf.stats())
    assert pf.stats()["consumed"] == rpf.stats()["consumed"] == 1
