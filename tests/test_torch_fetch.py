"""`fetch_reads` / `fetch_block_range` / `fetch_records` of the PyTorch
port's `CompressedResidentStore` on the CPU against the JAX reference
store: the same padded rows and lengths, byte for byte, on the fused
device path and on the depth-bucketed staged path."""
import numpy as np
import pytest

from repro.core import encoder as renc
from repro.core import format as rfmt
from repro.core.index import ReadIndex as RIndex
from repro.core.residency import CompressedResidentStore as RStore
from repro_torch.api.address import ReadId, Region
from repro_torch.core import format as pfmt
from repro_torch.core.index import ReadIndex as PIndex
from repro_torch.core.residency import CompressedResidentStore as PStore
from test_torch_kernels import deep_chain_payload


@pytest.fixture(scope="module")
def stores(fastq_platinum):
    a = renc.encode(fastq_platinum, block_size=4096)
    ridx = RIndex.build(fastq_platinum, 4096)
    pidx = PIndex(starts=ridx.starts.copy(), block_size=4096)
    return (RStore(a, ridx, backend="ref"),
            PStore(pfmt.deserialize(rfmt.serialize(a)), pidx, device="cpu"),
            ridx, np.frombuffer(fastq_platinum, np.uint8))


def _same(r_out, p_out):
    for r, p in zip(r_out, p_out):
        np.testing.assert_array_equal(p.cpu().numpy(), np.asarray(r))


def _check_source(out, lens, ids, src, idx):
    out, lens = out.numpy(), lens.numpy()
    for i, rid in enumerate(ids):
        lo, hi, _ = idx.lookup(int(rid))
        assert lens[i] == hi - lo
        np.testing.assert_array_equal(out[i, :hi - lo], src[lo:hi])
        assert not out[i, hi - lo:].any()


@pytest.mark.parametrize("batch", [1, 5, 256])
def test_fetch_reads_matches_reference(stores, batch):
    rs, ps, idx, src = stores
    ids = np.random.default_rng(batch).integers(0, idx.n_reads, batch)
    got = ps.fetch_reads(ids)
    _same(rs.fetch_reads(ids), got)
    _check_source(*got, ids, src, idx)


def test_fetch_reads_edge_ids_and_single_read(stores):
    rs, ps, idx, src = stores
    ids = np.array([0, 0, idx.n_reads - 1, 1, idx.n_reads - 1])
    _same(rs.fetch_reads(ids), ps.fetch_reads(ids))
    np.testing.assert_array_equal(ps.fetch_read(7), rs.fetch_read(7))
    out, lens = ps.fetch_reads(np.array([], np.int64))
    assert out.shape[0] == 0 and lens.shape[0] == 0
    for bad in ([idx.n_reads], [-1], [0, idx.n_reads + 7]):
        with pytest.raises(IndexError):
            ps.fetch_reads(np.array(bad))


def test_fetch_block_range_and_records_match_reference(stores):
    rs, ps, idx, src = stores
    n = ps.decoder.da.n_blocks
    for b0, b1 in ((0, 1), (2, 5), (n - 2, n), (3, 3)):
        _same([rs.fetch_block_range(b0, b1)], [ps.fetch_block_range(b0, b1)])
    with pytest.raises(IndexError):
        ps.fetch_block_range(0, n + 1)
    ids = np.array([0, 3, 17, 2])
    got = ps.fetch_records(ids, 700)
    _same([rs.fetch_records(ids, 700)], [got])
    for i, r in enumerate(ids):
        np.testing.assert_array_equal(got[i].numpy(),
                                      src[r * 700:(r + 1) * 700])


def test_verified_fetch_takes_the_staged_path(stores):
    rs, ps, idx, _ = stores
    ids = np.array([9, 4, 300])
    _same(rs.fetch_reads(ids, verify=True), ps.fetch_reads(ids, verify=True))
    assert ps.decoder.decoded_blocks_last == rs.decoder.decoded_blocks_last
    assert ps.decoder.launch_rounds_last == rs.decoder.launch_rounds_last


def test_shallow_selection_reroutes_to_bucketed_launches():
    """A covering set below the archive's deepest depth bucket decodes on
    the staged path, one launch per bucket, like the reference."""
    head = deep_chain_payload(20_000, seg=300, seed=1)
    tail = np.random.default_rng(2).integers(0, 256, 12_000, dtype=np.uint8)
    raw = np.concatenate([head, tail])
    a = renc.encode(raw.tobytes(), block_size=2048)
    rs = RStore(a, backend="ref")
    ps = PStore(pfmt.deserialize(rfmt.serialize(a)), device="cpu")
    assert ps.decoder.multi_bucket
    shallow = np.flatnonzero(ps.decoder.block_rounds
                             < ps.decoder.da.max_depth)
    rec = np.array([shallow[0] * 2048 // 100 + 1, shallow[-1] * 2048 // 100])
    for d in (rs.decoder, ps.decoder):
        d.launch_rounds_last = []
    got = ps.fetch_records(rec, 100)          # fixed 100-byte records
    _same([rs.fetch_records(rec, 100)], [got])
    assert ps.decoder.launch_rounds_last == rs.decoder.launch_rounds_last
    assert ps.decoder.launch_rounds_last       # went through decode_blocks
    for i, r in enumerate(rec):
        np.testing.assert_array_equal(got[i].numpy(),
                                      raw[r * 100:(r + 1) * 100])


def test_planner_matches_reference(stores):
    from repro.api.plan import QueryPlanner as RPlanner
    from repro_torch.api.plan import QueryPlanner as PPlanner
    rs, ps, idx, _ = stores
    ids = np.array([5, 1, 9])
    rp, pp = RPlanner(rs).plan_read_ids(ids), PPlanner(ps).plan_read_ids(ids)
    for f in ("starts", "lengths", "device_ids"):
        np.testing.assert_array_equal(getattr(pp, f), getattr(rp, f))
    assert pp.geom() == rp.geom()[:4] and pp.max_depth == rp.max_depth
    for a, b in zip(pp.host_cover(), rp.host_cover()):
        np.testing.assert_array_equal(a, b)
    mixed = PPlanner(ps).plan([ReadId(3), slice(10, 4000), 8])
    assert mixed.device_ids is None and mixed.n_queries == 3
    # a Region needs a name table, in both packages
    from repro.api.address import Region as RRegion
    for planner, region in ((RPlanner(rs), RRegion), (PPlanner(ps), Region)):
        with pytest.raises(ValueError, match="NameTable"):
            planner.plan([region(b"SRR0.3")])


def test_stats_and_unported_options(stores, fastq_platinum):
    rs, ps, _, _ = stores
    st, want = ps.stats(), rs.stats()
    assert (st.raw_size, st.n_blocks) == (want.raw_size, want.n_blocks)
    da = ps.decoder.da
    assert st.compressed_device_bytes == sum(
        t.numel() * t.element_size()
        for t in (da.words, da.word_off, da.n_syms, da.lanes, da.n_cmds,
                  da.block_start, da.block_len))
    a = ps.decoder.archive
    assert PStore(a, device="cpu", cache_blocks=8).cache_info()[
        "capacity"] == 8
    with pytest.raises(NotImplementedError, match="self-healing"):
        PStore(a, device="cpu", on_error="partial")
    _same(rs.fetch_reads([0], mode2=False), ps.fetch_reads([0], mode2=False))
