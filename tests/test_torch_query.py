"""The PyTorch port's query plane on the CPU against the JAX reference:
`parse_region`, the device `NameTable` (the same read ids, `KeyError` and
`missing_ok`), mixed address spaces, regions straddling blocks, samtools
full-string precedence, the `GenomicArchive` facade and its `[]` forms,
and `save`/`open` byte-compatible both ways between the packages."""
import numpy as np
import pytest
import torch

from repro.api import GenomicArchive as RGA
from repro.api import address as raddr
from repro_torch.api import (ByteRange, GenomicArchive, NameTable, ReadId,
                             Region, parse_region)
from repro_torch.api import address as paddr
from repro_torch.core.format import CorruptArchiveError

BS = 4096


@pytest.fixture(scope="module")
def gas():
    from repro.data.fastq import make_fastq
    data = make_fastq("platinum", n_reads=250, seed=1)
    return (RGA.from_bytes(data, block_size=BS, backend="ref"),
            GenomicArchive.from_bytes(data, block_size=BS, device="cpu"),
            np.frombuffer(data, np.uint8))


def span(ga, r):
    return ga.store.index.lookup(int(r))[:2]


def same_query(rga, pga, r_addrs, p_addrs):
    want = rga.query(r_addrs)
    got = pga.query(p_addrs)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


# ------------------------------------------------------- address parsing
@pytest.mark.parametrize("text", [
    "SRR0.7", "SRR0.7:100", "SRR0.7:100-200", "SRR0.7:100-", "M00:1:ABC",
    b"M00:1:ABC-2", "r:0-5", "r:9-5"])
def test_parse_region_matches_reference(text):
    try:
        want = raddr.parse_region(text)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            parse_region(text)
        return
    got = parse_region(text)
    assert (got.name, got.start, got.end) == (want.name, want.start,
                                              want.end)


# ----------------------------------------------------------- name table
def test_name_table_ids_equal_reference(gas):
    rga, pga, _ = gas
    nt = pga.names
    assert nt.n_names == pga.n_reads == rga.names.n_names
    assert nt.keys.dtype == torch.int64 and nt.ids.dtype == torch.int32
    names = [f"SRR0.{i}".encode() for i in range(pga.n_reads)][::-1]
    np.testing.assert_array_equal(nt.lookup(names),
                                  rga.names.lookup(names))
    probe = [b"SRR0.0", b"absent", b"SRR0.123", b""]
    np.testing.assert_array_equal(
        nt.lookup(probe, missing_ok=True),
        rga.names.lookup(probe, missing_ok=True))
    with pytest.raises(KeyError, match="no record named b'absent'"):
        nt.lookup(probe)
    assert nt.lookup([]).shape == (0,)


def test_name_table_build_rejects_duplicates_and_sorts_unsigned():
    with pytest.raises(ValueError, match="duplicate"):
        NameTable.build([b"a", b"b", b"a"], device="cpu")
    empty = NameTable.build([], device="cpu")
    assert empty.lookup([b"x"], missing_ok=True).tolist() == [-1]
    with pytest.raises(KeyError, match="empty"):
        empty.lookup([b"x"])
    # hashes above 2^63 sort after those below: the sign-flipped keys
    rng = np.random.default_rng(8)
    names = list({rng.bytes(12) for _ in range(300)})
    h = np.array([paddr._fnv1a64(n) for n in names], np.uint64)
    assert (h >= np.uint64(1 << 63)).any() and (h < np.uint64(1 << 63)).any()
    nt = NameTable.build(names, device="cpu")
    np.testing.assert_array_equal(nt.lookup(names), np.arange(len(names)))
    np.testing.assert_array_equal(
        nt.ids.numpy(), np.argsort(h, kind="stable"))
    assert [raddr._fnv1a64(n) for n in names] == h.tolist()


# ------------------------------------------------------------ queries
def test_entry_points_bit_identical(gas):
    rga, pga, src = gas
    ids = np.random.default_rng(0).integers(0, pga.n_reads, 32)
    q_rows, q_lens = same_query(rga, pga, [raddr.ReadId(int(i)) for i in ids],
                                [ReadId(int(i)) for i in ids])
    f_rows, f_lens = pga.store.fetch_reads(ids)
    assert torch.equal(q_rows, f_rows) and torch.equal(q_lens, f_lens)
    for i in (0, 7, 31):
        lo, hi = span(pga, ids[i])
        got = q_rows[i, :int(q_lens[i])].numpy()
        np.testing.assert_array_equal(got, pga.store.decoder.decode_range(
            lo, hi))
        np.testing.assert_array_equal(got, src[lo:hi])


def test_query_mixed_address_spaces(gas):
    rga, pga, src = gas
    rows, lens = same_query(
        rga, pga,
        [raddr.ReadId(7), raddr.ByteRange(100, 900), raddr.Region(b"SRR0.7"),
         "SRR0.9:5-40", 3, slice(5, 77)],
        [ReadId(7), ByteRange(100, 900), Region(b"SRR0.7"), "SRR0.9:5-40",
         3, slice(5, 77)])
    lo7, hi7 = span(pga, 7)
    assert rows[0, :int(lens[0])].numpy().tobytes() == src[lo7:hi7].tobytes()
    assert torch.equal(rows[2], rows[0]) and int(lens[2]) == int(lens[0])
    lo9, _ = span(pga, 9)
    np.testing.assert_array_equal(rows[3, :int(lens[3])].numpy(),
                                  src[lo9 + 4:lo9 + 40])


def test_empty_query_and_unported_entry_points(gas):
    _, pga, _ = gas
    rows, lens = pga.query([])
    assert rows.shape[0] == 0 and lens.shape[0] == 0
    # the autotuner is ported: the reference's refusal of an empty corpus
    for cls in (GenomicArchive, RGA):
        with pytest.raises(ValueError, match="empty"):
            cls.create(b"")
    # the training data plane is ported: the same refusal of variable
    # records without seq_len, the same batches with it
    rga = gas[0]
    for ga in (pga, rga):
        with pytest.raises(ValueError, match="seq_len"):
            ga.dataset()
    got = pga.dataset(batch_size=3, seq_len=50, prefetch=0).batch_at(2)
    want = rga.dataset(batch_size=3, seq_len=50, prefetch=0).batch_at(2)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # the self-healing surface is ported: the same counters and masks
    addrs = [ReadId(3), ByteRange(10, 900)]
    pga.query(addrs, verify=True, on_error="partial")
    rga.query([3, slice(10, 900)], verify=True, on_error="partial")
    assert pga.recover_info() == rga.recover_info()
    np.testing.assert_array_equal(pga.last_corrupt, rga.last_corrupt)
    pg = GenomicArchive.from_bytes(b"@a\nAC\n+\nFF\n", parity_group=2,
                                   device="cpu")
    assert pg.store.decoder.archive.parity_group == 2


def test_region_straddles_block_boundary_bit_identical(gas):
    rga, pga, src = gas
    idx = pga.store.index
    straddlers = [r for r in range(idx.n_reads)
                  if idx.lookup(r)[0] // BS != (idx.lookup(r)[1] - 1) // BS]
    assert straddlers
    for r in straddlers[:4]:
        lo, hi = span(pga, r)
        name = f"SRR0.{r}"
        np.testing.assert_array_equal(pga[name], src[lo:hi])
        cut = BS * (lo // BS + 1) - lo
        s1, e1 = max(1, cut - 10), min(hi - lo, cut + 10)
        got = pga[f"{name}:{s1}-{e1}"]
        np.testing.assert_array_equal(got, src[lo + s1 - 1:lo + e1])
        np.testing.assert_array_equal(got, rga[f"{name}:{s1}-{e1}"])


def test_region_bounds_checked(gas):
    _, pga, _ = gas
    lo, hi = span(pga, 3)
    with pytest.raises(IndexError, match="region"):
        pga.query([Region(b"SRR0.3", 0, hi - lo + 1)])
    with pytest.raises(KeyError, match="no record named"):
        pga.query(["absent:1-5"])


def test_full_string_name_precedence_over_coordinate_suffix():
    recs = [b"@" + n + b"\nACGTACGTAC\n+\nFFFFFFFFFF\n"
            for n in (b"M0:3:1101", b"M0:3", b"plain")]
    data = b"".join(recs)
    pga = GenomicArchive.from_bytes(data, block_size=BS, device="cpu")
    rga = RGA.from_bytes(data, block_size=BS, backend="ref")
    src = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(pga["M0:3:1101"], src[:len(recs[0])])
    np.testing.assert_array_equal(pga["M0:3:1101"], rga["M0:3:1101"])
    s2 = len(recs[0]) + len(recs[1])
    np.testing.assert_array_equal(pga["plain:2-5"], src[s2 + 1:s2 + 5])
    np.testing.assert_array_equal(pga["M0:3:2-4"], rga["M0:3:2-4"])


def test_getitem_forms_and_sugar(gas):
    rga, pga, src = gas
    lo, hi = span(pga, 11)
    np.testing.assert_array_equal(pga[200:700], src[200:700])
    np.testing.assert_array_equal(pga[11], src[lo:hi])
    np.testing.assert_array_equal(pga["SRR0.11"], src[lo:hi])
    np.testing.assert_array_equal(pga["SRR0.7:100-"], rga["SRR0.7:100-"])
    assert len(pga) == pga.n_reads == len(rga)
    assert (pga.raw_size, pga.block_size) == (rga.raw_size, rga.block_size)
    assert pga.stats().n_blocks == rga.stats().n_blocks
    assert pga.cache_info() == rga.cache_info()
    assert "250 reads" in repr(pga) and "250 named" in repr(pga)


def test_plan_geometry_matches_reference(gas):
    rga, pga, _ = gas
    addrs = [(0, 10), (BS - 1, BS + 1)]
    pp = pga.plan([ByteRange(*s) for s in addrs])
    rp = rga.plan([raddr.ByteRange(*s) for s in addrs])
    for a, b in zip(pp.host_cover(), rp.host_cover()):
        np.testing.assert_array_equal(a, b)
    assert pp.host_cover()[3].tolist() == [0, 1]
    assert (pp.max_span, pp.n_queries, pp.max_len) == (rp.max_span,
                                                       rp.n_queries,
                                                       rp.max_len)


@pytest.mark.parametrize("mode2", [True, False], ids=["mode2", "mode1"])
def test_stream_facade(gas, mode2):
    rga, pga, src = gas
    addrs = [(0, pga.raw_size)]
    got = list(pga.stream([ByteRange(*s) for s in addrs],
                          max_resident_bytes=6 * BS, mode2=mode2,
                          verify=True))
    want = list(rga.stream([raddr.ByteRange(*s) for s in addrs],
                           max_resident_bytes=6 * BS, mode2=mode2,
                           verify=True))
    assert len(got) == len(want) > 1
    assert np.concatenate(got).tobytes() == src.tobytes()


# ---------------------------------------------------------- persistence
@pytest.mark.parametrize("kind", ["fastq", "records", "global"])
def test_save_open_both_ways(tmp_path, kind):
    from repro.data.fastq import make_fastq
    data = make_fastq("noisy", n_reads=120, seed=4)
    if kind == "records":
        build = dict(record_bytes=100)
        r = RGA.from_records(data, block_size=2048, backend="ref", **build)
        p = GenomicArchive.from_records(data, block_size=2048, device="cpu",
                                        **build)
        data = data[:len(data) // 100 * 100]
    else:
        kw = (dict(mode="global", anchor_interval=2) if kind == "global"
              else {})
        r = RGA.from_bytes(data, block_size=2048, backend="ref", **kw)
        p = GenomicArchive.from_bytes(data, block_size=2048, device="cpu",
                                      **kw)
    rp, pp = tmp_path / "ref.acegad", tmp_path / "port.acegad"
    assert p.save(str(pp)) == r.save(str(rp))
    assert pp.read_bytes() == rp.read_bytes()
    opened = GenomicArchive.open(str(rp), device="cpu", cache_blocks=4)
    back = RGA.open(str(pp), backend="ref")
    assert len(opened) == len(back) == len(p)
    for ga in (opened, back):
        np.testing.assert_array_equal(ga[0:len(data)],
                                      np.frombuffer(data, np.uint8))
    np.testing.assert_array_equal(opened[5], back[5])
    if kind != "records":
        np.testing.assert_array_equal(opened["SRR0.9"], back["SRR0.9"])


def test_open_rejects_corrupt_containers(tmp_path, gas):
    _, pga, _ = gas
    good = tmp_path / "good.acegad"
    pga.save(str(good))
    blob = good.read_bytes()
    for name, bad, why in (
            ("short", blob[:5], "truncated"),
            ("magic", b"NOTMAGIC" + blob[8:], "not a GenomicArchive"),
            ("hlen", blob[:8] + b"\xff\xff\xff\x7f" + blob[12:], "overruns"),
            ("json", blob[:12] + b"\x00" + blob[13:], "not valid JSON")):
        path = tmp_path / name
        path.write_bytes(bad)
        with pytest.raises(CorruptArchiveError, match=why):
            GenomicArchive.open(str(path), device="cpu")
