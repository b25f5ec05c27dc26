"""The PyTorch port's `StreamingExecutor` and `Decoder.decode_all` on the
CPU against the JAX reference: the same chunks byte for byte, the same
`chunk_log` field by field, the same budget rules ("ra", anchored and
anchor-free global), and the same `decoded_blocks_last` /
`launch_rounds_last` after a whole-file decode."""
import dataclasses

import numpy as np
import pytest

from repro.api.address import ByteRange as RByteRange
from repro.api.address import ReadId as RReadId
from repro.api.address import Region as RRegion
from repro.api.executors import StreamingExecutor as RStream
from repro.core import decoder as rdec
from repro.core import encoder as renc
from repro.core.index import ReadIndex as RIndex
from repro.core.residency import CompressedResidentStore as RStore
from repro_torch.api.address import ByteRange, ReadId, Region
from repro_torch.api.executors import StreamingExecutor
from repro_torch.core import decoder as pdec
from repro_torch.core.index import ReadIndex as PIndex
from repro_torch.core.residency import CompressedResidentStore as PStore
from test_torch_decoder import port_archive
from test_torch_kernels import deep_chain_payload

BS = 4096


def mixed_payload(block_size: int) -> bytes:
    """Deep-chain head + incompressible tail: blocks in several depth
    buckets (as `tests/test_depth_sched.py` builds it)."""
    rng = np.random.default_rng(3)
    head = deep_chain_payload(2 * block_size, seg=min(1024, block_size // 4),
                              seed=1)
    tail = rng.integers(0, 256, 2 * block_size, dtype=np.uint8)
    return np.concatenate([head, tail]).tobytes()


def stores(data: bytes, names: bool = False, **enc):
    """(reference store, port store) over one reference encode."""
    a = renc.encode(data, block_size=BS, **enc)
    ridx = pidx = None
    if names:
        ridx = RIndex.build(data, BS)
        pidx = PIndex(starts=ridx.starts.copy(), block_size=BS)
    return (RStore(a, ridx, backend="ref"),
            PStore(port_archive(a), pidx, device="cpu"))


def same_log(r_ex, p_ex):
    assert [dataclasses.astuple(c) for c in p_ex.chunk_log] == \
        [dataclasses.astuple(c) for c in r_ex.chunk_log]


def run_both(rs, ps, r_addrs, p_addrs, **kw):
    """Stream the same addresses through both executors → (chunks, the
    executors); every chunk is byte-equal between the packages."""
    r_ex = RStream(rs, **kw)
    p_ex = StreamingExecutor(ps, **kw)
    r_chunks = list(r_ex.chunks(r_addrs))
    p_chunks = list(p_ex.chunks(p_addrs))
    assert len(p_chunks) == len(r_chunks)
    for r, p in zip(r_chunks, p_chunks):
        np.testing.assert_array_equal(p, r)
    same_log(r_ex, p_ex)
    return p_chunks, p_ex


@pytest.fixture(scope="module")
def fastq_pair():
    from repro.data.fastq import make_fastq
    data = make_fastq("platinum", n_reads=250, seed=1)
    return data, stores(data, names=True)


# ------------------------------------------------- decode_all, repaired
@pytest.mark.parametrize("verify", [False, True], ids=["plain", "verify"])
@pytest.mark.parametrize("mode2", [True, False], ids=["mode2", "mode1"])
@pytest.mark.parametrize("enc", [{}, {"mode": "global", "anchor_interval": 3},
                                 {"mode": "global"}],
                         ids=["ra", "anchored", "anchor_free"])
def test_decode_all_counters_match_reference(enc, mode2, verify):
    """A multi-bucket archive: after `decode_all(chunk_blocks=k)` the
    last chunk's `decoded_blocks_last` and `launch_rounds_last` equal the
    reference's — whose unverified decode_all streams exact-size depth
    buckets (pad_groups=False), not pow2-padded ones."""
    raw = deep_chain_payload(24_000, seg=300, seed=3)
    tail = np.random.default_rng(4).integers(0, 256, 9000, dtype=np.uint8)
    data = np.concatenate([raw, tail]).tobytes()
    a = renc.encode(data, block_size=2048, **enc)
    r = rdec.Decoder(a, backend="ref")
    p = pdec.Decoder(port_archive(a), device="cpu")
    # an anchor-free archive is one window, so one depth bucket
    assert p.multi_bucket == bool(a.anchor_interval or a.mode == "ra")
    for k in (7, a.n_blocks):
        got = p.decode_all(chunk_blocks=k, mode2=mode2, verify=verify)
        assert got.tobytes() == data
        np.testing.assert_array_equal(got, r.decode_all(
            chunk_blocks=k, mode2=mode2, verify=verify))
        assert p.decoded_blocks_last == r.decoded_blocks_last
        assert p.launch_rounds_last == r.launch_rounds_last


# ------------------------------------------------------------ budgets
def test_stream_larger_than_budget_bit_perfect(fastq_pair):
    data, (rs, ps) = fastq_pair
    budget = 3 * BS
    chunks, ex = run_both(rs, ps, [RByteRange(0, len(data))],
                          [ByteRange(0, len(data))],
                          max_resident_bytes=budget)
    assert len(chunks) > 1
    assert np.concatenate(chunks).tobytes() == data
    for st in ex.chunk_log:
        assert st.resident_bytes <= budget and st.yielded_bytes <= budget


def test_stream_mixed_addresses_in_order(fastq_pair):
    data, (rs, ps) = fastq_pair
    idx = ps.index
    lo3, hi3, _ = idx.lookup(3)
    lo9, hi9, _ = idx.lookup(9)
    # a Region needs the name table: stream through the facade's planner
    from repro.api import GenomicArchive as RGA
    from repro_torch.api import GenomicArchive as PGA
    rga, pga = RGA(rs, names=_names(data)), PGA(ps, names=_names(data))
    budget = 4 * BS
    r_ex = RStream(rs, max_resident_bytes=budget, planner=rga.planner)
    p_ex = StreamingExecutor(ps, max_resident_bytes=budget,
                             planner=pga.planner)
    got = np.concatenate(list(p_ex.chunks(
        [ReadId(3), ByteRange(10, 5000), Region(b"SRR0.9")])))
    want = np.concatenate(list(r_ex.chunks(
        [RReadId(3), RByteRange(10, 5000), RRegion(b"SRR0.9")])))
    np.testing.assert_array_equal(got, want)
    assert got.tobytes() == data[lo3:hi3] + data[10:5000] + data[lo9:hi9]
    same_log(r_ex, p_ex)


def _names(data: bytes):
    from repro_torch.core.index import parse_fastq_records
    return parse_fastq_records(data)[1]


def test_stream_budget_accounts_for_pow2_batch_padding(fastq_pair):
    """Six spans pack into chunks whose gather is costed at the pow2-padded
    batch, as in the reference."""
    data, (rs, ps) = fastq_pair
    budget = 3 * BS
    spans = [(i * 1500, i * 1500 + 1400) for i in range(6)]
    chunks, ex = run_both(rs, ps, [RByteRange(*s) for s in spans],
                          [ByteRange(*s) for s in spans],
                          max_resident_bytes=budget)
    assert np.concatenate(chunks).tobytes() == b"".join(
        data[lo:hi] for lo, hi in spans)
    for st in ex.chunk_log:
        assert st.resident_bytes <= budget


def test_stream_budget_too_small_and_sharded_rejected(fastq_pair):
    _, (rs, ps) = fastq_pair
    for cls, store in ((RStream, rs), (StreamingExecutor, ps)):
        with pytest.raises(ValueError, match="max_resident_bytes"):
            cls(store, max_resident_bytes=BS)
    # sharded streaming is mode-2 only, in both
    for cls, store in ((RStream, rs), (StreamingExecutor, ps)):
        with pytest.raises(ValueError, match="mode-2 only"):
            cls(store, max_resident_bytes=8 * BS, sharded=object(),
                mode2=False)


@pytest.mark.parametrize("mode2", [True, False], ids=["mode2", "mode1"])
def test_stream_budget_holds_for_anchored_global(fastq_pair, mode2):
    """Anchored archives stream under a budget of two windows; a budget
    below one window is rejected; anchor-free archives need the whole
    prefix."""
    data = fastq_pair[0]
    rs, ps = stores(data, mode="global", anchor_interval=4)
    budget = 8 * BS
    chunks, ex = run_both(rs, ps, [RByteRange(0, len(data))],
                          [ByteRange(0, len(data))],
                          max_resident_bytes=budget, mode2=mode2)
    assert len(chunks) > 1 and np.concatenate(chunks).tobytes() == data
    for st in ex.chunk_log:
        assert st.resident_bytes <= budget
    for cls, store in ((RStream, rs), (StreamingExecutor, ps)):
        with pytest.raises(ValueError, match="anchor_interval=4"):
            cls(store, max_resident_bytes=4 * BS)
    rf, pf = stores(data, mode="global")
    n = pf.decoder.da.n_blocks
    for cls, store in ((RStream, rf), (StreamingExecutor, pf)):
        with pytest.raises(ValueError, match="anchor-free global"):
            cls(store, max_resident_bytes=(n - 1) * BS)
    chunks, ex = run_both(rf, pf, [RByteRange(0, len(data))],
                          [ByteRange(0, len(data))],
                          max_resident_bytes=2 * (n + 1) * BS, mode2=mode2)
    assert np.concatenate(chunks).tobytes() == data
    # an interval past n_blocks bounds the requirement at the archive
    rt, pt = stores(data[:5 * BS], mode="global", anchor_interval=999)
    StreamingExecutor(pt, max_resident_bytes=2 * 5 * BS)


@pytest.mark.parametrize("mode,interval", [("ra", 0), ("global", 4)])
def test_stream_verify_clean(fastq_pair, mode, interval):
    data = fastq_pair[0]
    rs, ps = stores(data, mode=mode, anchor_interval=interval)
    chunks, _ = run_both(rs, ps, [RByteRange(0, len(data))],
                         [ByteRange(0, len(data))],
                         max_blocks_per_chunk=3, verify=True)
    assert np.concatenate(chunks).tobytes() == data


def test_stream_verify_corrupt_names_the_block(fastq_pair):
    """A flipped literal word of block 2: the first chunk (blocks 0-1)
    streams, the next raises `BlockDigestError` naming block 2."""
    from repro_torch.core.format import S_LITERALS
    data = fastq_pair[0]
    pa = port_archive(renc.encode(data, block_size=BS))
    pa.words[int(pa.word_off[2, S_LITERALS]) + 1] ^= 0x5A
    ps = PStore(pa, device="cpu")
    it = StreamingExecutor(ps, max_blocks_per_chunk=2, verify=True).chunks(
        [ByteRange(0, len(data))])
    first = next(it)
    assert first.tobytes() == data[:first.size]
    with pytest.raises(pdec.BlockDigestError, match="block 2"):
        list(it)


def test_streaming_buckets_within_budget():
    """Depth-bucketed streaming: chunks decode exact-size buckets inside
    the budget; a shallow-only stream never pays the deep bound."""
    data = mixed_payload(BS)
    rs, ps = stores(data)
    budget = 4 * BS
    chunks, ex = run_both(rs, ps, [RByteRange(0, len(data))],
                          [ByteRange(0, len(data))],
                          max_resident_bytes=budget)
    assert np.concatenate(chunks).tobytes() == data
    d = ps.decoder
    shallow = np.flatnonzero(d.block_rounds < d.da.max_depth)
    lo = int(shallow[0]) * BS
    hi = min(len(data), (int(shallow[-1]) + 1) * BS)
    chunks, _ = run_both(rs, ps, [RByteRange(lo, hi)], [ByteRange(lo, hi)],
                         max_resident_bytes=budget)
    assert np.concatenate(chunks).tobytes() == data[lo:hi]
    assert d.launch_rounds_last == rs.decoder.launch_rounds_last
    assert max(d.launch_rounds_last) < d.da.max_depth
