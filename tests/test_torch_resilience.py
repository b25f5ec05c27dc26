"""Self-healing decode of the PyTorch port on the CPU against the JAX
reference: parity-protected archives, fault injection, and the
partial-failure semantics (detect → recover → degrade).

Every scenario runs in both packages on the same archive (the
reference's serialized bytes) with injectors of the same seed, and holds
the port to the reference after each fault: the same decoded bytes, the
same `FaultInjector.log` (block, word and bit), the same
`recover_info()`, the same `decoded_blocks_last` / `launch_rounds_last`,
`cache_info()`, `chunk_log` and `last_corrupt` — and, as the reference's
own tests do, never silently wrong bytes. The sharded, prefetch and
training-backoff cases wait for the multi-GPU and training slices."""
import dataclasses
import struct

import numpy as np
import pytest

from repro.core import format as rfmt
from repro.core.decoder import BlockDigestError as RDigestError
from repro.core.decoder import Decoder as RDecoder
from repro.core.encoder import encode as rencode
from repro.core.index import ReadIndex as RIndex
from repro.core.residency import CompressedResidentStore as RStore
from repro.resilience.faults import FaultInjector as RInjector
from repro_torch.core import format as pfmt
from repro_torch.core.decoder import BlockDigestError, Decoder
from repro_torch.core.encoder import encode
from repro_torch.core.format import CorruptArchiveError, block_payload_bounds
from repro_torch.core.index import ReadIndex
from repro_torch.core.residency import CompressedResidentStore
from repro_torch.resilience.faults import (FaultInjector,
                                           TransientDecodeError)


def _data(n=16 * 1024, seed=3):
    rng = np.random.default_rng(seed)
    motif = rng.integers(0, 255, 64, dtype=np.uint8)
    reps = np.tile(motif, n // 64 + 1)[:n]
    noise = rng.integers(0, 255, n, dtype=np.uint8)
    return np.where(rng.random(n) < 0.2, noise, reps) \
        .astype(np.uint8).tobytes()


DATA = _data()
REF = np.frombuffer(DATA, np.uint8)


def port_archive(a):
    return pfmt.deserialize(rfmt.serialize(a))


def decoders(**kw):
    """(reference, port) decoders over one archive encoded by the
    reference, each with its own copy of the words."""
    a = rencode(DATA, block_size=256, **kw)
    return RDecoder(a, backend="ref"), Decoder(port_archive(a), device="cpu")


def stores(cache_blocks=0, **kw):
    """(reference, port) stores with 128-byte records over a parity-4
    archive; `kw` are the store knobs."""
    a = rencode(DATA, block_size=256, parity_group=4)
    n = len(DATA) // 128
    return (RStore(a, RIndex.fixed_records(n, 128, 256), backend="ref",
                   cache_blocks=cache_blocks, **kw),
            CompressedResidentStore(
                port_archive(a), ReadIndex.fixed_records(n, 128, 256),
                device="cpu", cache_blocks=cache_blocks, **kw))


def same_state(r, p):
    """The decoder counters and the repaired words agree."""
    assert p.recover_info() == r.recover_info()
    assert p.decoded_blocks_last == r.decoded_blocks_last
    assert list(p.launch_rounds_last) == list(r.launch_rounds_last)
    np.testing.assert_array_equal(p.last_bad_blocks, r.last_bad_blocks)
    np.testing.assert_array_equal(p.archive.words, r.archive.words)
    np.testing.assert_array_equal(
        p.da.words.numpy().view(np.uint16), p.archive.words)


def flip_both(fr, fp, r, p, **kw):
    er = fr.flip_payload_word(r, **kw)
    ep = fp.flip_payload_word(p, **kw)
    assert ep == er
    return ep


# --------------------------------------------------------------- format v4
@pytest.mark.parametrize("mode,k", [("ra", 1), ("ra", 4), ("global", 1),
                                    ("global", 4)])
def test_parity_tail_roundtrip_and_v3_stability(mode, k):
    kw = dict(block_size=256, mode=mode, parity_group=k,
              anchor_interval=8 if mode == "global" else 0)
    a = encode(DATA, **kw)
    buf = pfmt.serialize(a)
    assert buf == rfmt.serialize(rencode(DATA, **kw))
    assert buf[:8] == pfmt.MAGIC_V4 == b"ACEJAX05"
    b = pfmt.deserialize(buf)
    assert b.parity_group == k and a.parity_words.size > 0
    np.testing.assert_array_equal(a.parity_words, b.parity_words)
    np.testing.assert_array_equal(a.parity_off, b.parity_off)
    assert np.array_equal(Decoder(b, device="cpu").decode_all(), REF)
    # parity-free archives stay byte-identical v3
    plain = encode(DATA, block_size=256)
    assert pfmt.serialize(plain)[:8] == pfmt.MAGIC == b"ACEJAX04"


def test_deserialize_typed_corruption_errors():
    buf = pfmt.serialize(encode(DATA, block_size=256, parity_group=4))
    with pytest.raises(CorruptArchiveError, match="magic"):
        pfmt.deserialize(b"XXXXXXXX" + buf[8:])
    with pytest.raises(CorruptArchiveError):
        pfmt.deserialize(buf[:40])                      # truncated header
    with pytest.raises(CorruptArchiveError):
        pfmt.deserialize(buf[:-10])                     # truncated parity


def test_archive_open_typed_container_errors(tmp_path):
    from repro.api.archive import GenomicArchive as RGA
    from repro_torch.api.archive import GenomicArchive
    ga = GenomicArchive.from_records(DATA, record_bytes=128,
                                     block_size=256, parity_group=4,
                                     device="cpu")
    p = str(tmp_path / "a.bin")
    ga.save(p)
    rp = str(tmp_path / "r.bin")
    RGA.from_records(DATA, record_bytes=128, block_size=256,
                     parity_group=4, backend="ref").save(rp)
    blob = open(p, "rb").read()
    assert blob == open(rp, "rb").read()

    def write(b):
        q = str(tmp_path / "bad.bin")
        open(q, "wb").write(b)
        return q

    with pytest.raises(CorruptArchiveError, match="magic"):
        GenomicArchive.open(write(b"NOTMAGIC" + blob[8:]), device="cpu")
    with pytest.raises(CorruptArchiveError, match="truncated"):
        GenomicArchive.open(write(blob[:6]), device="cpu")
    with pytest.raises(CorruptArchiveError, match="overruns"):
        GenomicArchive.open(write(blob[:8] + struct.pack("<I", 1 << 30)
                                  + blob[12:]), device="cpu")
    (hlen,) = struct.unpack_from("<I", blob, 8)
    with pytest.raises(CorruptArchiveError, match="JSON"):
        GenomicArchive.open(write(blob[:12] + b"\xff" * hlen
                                  + blob[12 + hlen:]), device="cpu")
    with pytest.raises(CorruptArchiveError, match="no archive payload"):
        GenomicArchive.open(write(blob[:12 + hlen]), device="cpu")
    # the unmangled file opens clean, knobs thread through
    ga2 = GenomicArchive.open(p, device="cpu", verify=True,
                              on_error="repair")
    assert ga2.store.on_error == "repair" and ga2.store.verify
    assert np.array_equal(ga2.store.decoder.decode_all(), REF)


# ------------------------------------------------- repair-or-typed property
@pytest.mark.parametrize("mode,entropy,anchors", [
    ("ra", "rans", 0), ("ra", "raw", 0),
    ("global", "rans", 0), ("global", "raw", 0),
    ("global", "rans", 8), ("global", "raw", 8),
])
def test_corrupt_word_repairs_or_types_never_silent(mode, entropy, anchors):
    """Any corrupted payload word ⇒ bit-perfect parity repair (with
    parity) or a typed error (without) — in both packages, after the same
    flips, with the same counters."""
    kw = dict(mode=mode, entropy=entropy, anchor_interval=anchors)
    r, p = decoders(parity_group=4, **kw)
    fr, fp = RInjector(seed=11), FaultInjector(seed=11)
    for _ in range(20):
        flip_both(fr, fp, r, p)
        want = r.decode_all(verify=True, on_error="repair")
        got = p.decode_all(verify=True, on_error="repair")
        assert np.array_equal(got, REF), \
            f"{mode}/{entropy}/{anchors}: SILENT CORRUPTION (parity)"
        np.testing.assert_array_equal(got, want)
        same_state(r, p)
        if p.recover_info()["reconstructed"] >= 1:
            break
    else:
        pytest.fail("no flip detected in 20 trials")
    assert fp.log == fr.log
    # without parity: a typed BlockDigestError naming the gap, or the flip
    # was dead (padding slack) and the output stayed bit-perfect
    r2, p2 = decoders(**kw)
    fr2, fp2 = RInjector(seed=12), FaultInjector(seed=12)
    for _ in range(20):
        flip_both(fr2, fp2, r2, p2)
        try:
            got = p2.decode_all(verify=True, on_error="repair")
        except BlockDigestError as e:
            assert "no parity" in str(e)
            with pytest.raises(RDigestError) as ei:
                r2.decode_all(verify=True, on_error="repair")
            assert str(ei.value) == str(e)
            same_state(r2, p2)
            break
        np.testing.assert_array_equal(
            got, r2.decode_all(verify=True, on_error="repair"))
        assert np.array_equal(got, REF), \
            f"{mode}/{entropy}/{anchors}: SILENT CORRUPTION (no parity)"
    else:
        pytest.fail("no flip detected in 20 trials")
    assert fp2.log == fr2.log


def test_corrupt_digest_table_always_fatal():
    """Parity covers payloads, not the digest table — a corrupted table
    means no trustworthy reference, so decode_all(verify) raises even
    under repair/partial, in both packages."""
    r, p = decoders(parity_group=4)
    assert FaultInjector(seed=5).corrupt_digest(p) == \
        RInjector(seed=5).corrupt_digest(r)
    for on_error in ("raise", "repair", "partial"):
        with pytest.raises(BlockDigestError, match="file digest"):
            p.decode_all(verify=True, on_error=on_error)
        with pytest.raises(RDigestError, match="file digest"):
            r.decode_all(verify=True, on_error=on_error)
    assert p.recover_info() == r.recover_info()


def test_single_corruption_repairs_across_paths():
    """decode_all, cached fetch_reads and streaming all return
    bit-perfect output from the same corrupted archive, with the
    reference's counters, cache counters (invalidations included) and
    chunk log."""
    from repro.api.address import ByteRange as RByteRange
    from repro.api.executors import StreamingExecutor as RStreaming
    from repro_torch.api.address import ByteRange
    from repro_torch.api.executors import StreamingExecutor
    rs, ps = stores(cache_blocks=8, verify=True, on_error="repair")
    r, p = rs.decoder, ps.decoder
    fr, fp = RInjector(seed=21), FaultInjector(seed=21)
    ids = np.arange(ps.index.n_reads)
    ref_rows = np.asarray(rs.fetch_reads(ids)[0])
    np.testing.assert_array_equal(ps.fetch_reads(ids)[0].numpy(), ref_rows)
    for _ in range(20):
        flip_both(fr, fp, r, p)
        assert np.array_equal(p.decode_all(verify=True, on_error="repair"),
                              REF)
        r.decode_all(verify=True, on_error="repair")
        same_state(r, p)
        np.testing.assert_array_equal(ps.fetch_reads(ids)[0].numpy(),
                                      ref_rows)
        rs.fetch_reads(ids)
        same_state(r, p)
        assert ps.cache_info() == rs.cache_info()
        if p.recover_info()["reconstructed"] >= 1:
            break
    else:
        pytest.fail("no flip detected")
    # streaming over the healed archive + a fresh corruption
    flip_both(fr, fp, r, p)
    ex = StreamingExecutor(ps, max_resident_bytes=256 * 16, verify=True,
                           on_error="repair")
    rex = RStreaming(rs, max_resident_bytes=256 * 16, verify=True,
                     on_error="repair")
    got = np.concatenate(list(ex.chunks([ByteRange(0, len(DATA))])))
    np.concatenate(list(rex.chunks([RByteRange(0, len(DATA))])))
    assert np.array_equal(got, REF)
    assert [dataclasses.astuple(c) for c in ex.chunk_log] == \
        [dataclasses.astuple(c) for c in rex.chunk_log]
    same_state(r, p)
    assert fp.log == fr.log


def _double_corruption_blocks(dec):
    starts, ends = block_payload_bounds(dec.archive)
    for g in range(dec.da.n_blocks // 4):
        c = [b for b in range(g * 4, (g + 1) * 4) if ends[b] - starts[b] > 2]
        if len(c) >= 2:
            return c[:2]
    raise AssertionError("no parity group with two nonempty payloads")


def test_double_corruption_partial_quarantines_and_serves():
    """Two corruptions in one parity group: unrecoverable. Under
    "partial" the blocks quarantine, hit addresses report typed corrupt
    outcomes (the same `last_corrupt` as the reference), healthy
    addresses stay bit-perfect — a ServingFrontend cycle maps them to
    ReadCorrupt results — and a later non-partial decode raises."""
    from repro.api.archive import GenomicArchive as RGA
    from repro.serving.frontend import ServingFrontend as RFrontend
    from repro_torch.api.archive import GenomicArchive
    from repro_torch.serving.frontend import ReadCorrupt, ServingFrontend
    rs, ps = stores(cache_blocks=8)
    r, p = rs.decoder, ps.decoder
    fe = ServingFrontend({"wgs": GenomicArchive(ps)}, verify=True,
                         on_error="partial")
    rfe = RFrontend({"wgs": RGA(rs)}, verify=True, on_error="partial")
    fe.register_tenant("clinical", "wgs")
    rfe.register_tenant("clinical", "wgs")
    fr, fp = RInjector(seed=31), FaultInjector(seed=31)
    blks = _double_corruption_blocks(p)
    assert blks == _double_corruption_blocks(r)
    ids = np.arange(ps.index.n_reads)
    ref_rows = np.asarray(rs.fetch_reads(ids)[0])
    ps.fetch_reads(ids)
    res = None
    for _ in range(20):
        for b in blks:
            flip_both(fr, fp, r, p, block=b)
        assert ps._cache.invalidate(np.asarray(blks, np.int64)) == \
            rs._cache.invalidate(np.asarray(blks, np.int64))
        tickets = [fe.submit("clinical", int(i)) for i in ids]
        rtickets = [rfe.submit("clinical", int(i)) for i in ids]
        fe.drain()
        rfe.drain()
        res = [fe.result(t) for t in tickets]
        rres = [rfe.result(t) for t in rtickets]
        assert [x.status for x in res] == [x.status for x in rres]
        same_state(r, p)
        assert ps.cache_info() == rs.cache_info()
        if any(x.status == "corrupt" for x in res):
            break
    else:
        pytest.fail("double corruption never detected")
    n_corrupt = 0
    for x, i in zip(res, ids):
        if x.status == "corrupt":
            n_corrupt += 1
            assert isinstance(x.payload, ReadCorrupt)
            assert x.payload.tenant == "clinical"
        else:
            assert np.array_equal(x.payload, ref_rows[i][:len(x.payload)]), \
                f"healthy request {i} disturbed"
    assert 0 < n_corrupt < len(res)
    info = p.recover_info()
    assert info["unrecoverable"] >= 1 and info["quarantined"] >= 1
    assert p.quarantined == r.quarantined
    assert fe.stats()["tenants"] == rfe.stats()["tenants"]
    assert fe.stats()["tenants"]["clinical"]["corrupt"] == n_corrupt
    # the same per-address mask from a direct partial fetch
    out = ps.fetch_reads(ids, verify=True, on_error="partial")[0].numpy()
    rout = np.asarray(rs.fetch_reads(ids, verify=True, on_error="partial")[0])
    np.testing.assert_array_equal(out, rout)
    np.testing.assert_array_equal(ps.last_corrupt, rs.last_corrupt)
    assert ps.last_corrupt.sum() == n_corrupt
    # quarantined blocks are never decoded again: no launch, zero rows
    p.decoded_blocks_last = 0
    rows = p.decode_blocks(np.asarray(blks), verify=True, on_error="partial")
    assert p.decoded_blocks_last == 0 and p.launch_rounds_last == []
    assert not rows.any()
    np.testing.assert_array_equal(p.last_bad_blocks, sorted(blks))
    # quarantine persists: a later non-partial decode raises
    with pytest.raises(BlockDigestError, match="quarantined"):
        p.decode_blocks(np.asarray(blks, np.int32), verify=True,
                        on_error="repair")
    with pytest.raises(RDigestError, match="quarantined"):
        r.decode_blocks(np.asarray(blks, np.int32), verify=True,
                        on_error="repair")


def test_transient_decode_failure_retries_clean():
    r, p = decoders(parity_group=4)
    FaultInjector(seed=41).transient_failures(p, n=1)
    RInjector(seed=41).transient_failures(r, n=1)
    from repro.resilience.faults import TransientDecodeError as RTransient
    with pytest.raises(TransientDecodeError):
        p.decode_all(verify=True)
    with pytest.raises(RTransient):
        r.decode_all(verify=True)
    assert np.array_equal(p.decode_all(verify=True), REF)
    assert np.array_equal(r.decode_all(verify=True), REF)
    assert p.fault_hook is None and r.fault_hook is None
    same_state(r, p)


def test_fault_injector_deterministic_log():
    """One seed corrupts the same block, word and bit in both packages."""
    def run(seed, dec, injector):
        fi = injector(seed=seed)
        for _ in range(5):
            fi.flip_payload_word(dec)
        fi.corrupt_digest(dec)
        return fi.log

    logs = {}
    for seed in (9, 10):
        r, p = decoders(parity_group=4)
        logs[seed] = run(seed, p, FaultInjector)
        assert logs[seed] == run(seed, r, RInjector)
        np.testing.assert_array_equal(p.archive.words, r.archive.words)
        np.testing.assert_array_equal(p.archive.block_fnv,
                                      r.archive.block_fnv)
    assert logs[9] == run(9, decoders(parity_group=4)[1], FaultInjector)
    assert logs[9] != logs[10]


def test_parity_group_one_is_replication():
    """k=1: every block gets its own parity copy — any single-block
    corruption is always repairable, even two corrupt blocks (they sit
    in different groups)."""
    r, p = decoders(parity_group=1)
    fr, fp = RInjector(seed=61), FaultInjector(seed=61)
    hit = 0
    for _ in range(30):
        flip_both(fr, fp, r, p)
        got = p.decode_all(verify=True, on_error="repair")
        assert np.array_equal(got, REF)
        r.decode_all(verify=True, on_error="repair")
        same_state(r, p)
        if p.recover_info()["reconstructed"] > hit:
            hit = p.recover_info()["reconstructed"]
            if hit >= 2:
                break
    assert hit >= 1


def test_shard_loss_waits_for_the_multi_gpu_slice():
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        FaultInjector(seed=0).drop_shard(None)


def test_chaos_smoke_lane(capsys):
    from repro_torch.resilience import chaos
    assert chaos.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "3/3 scenarios passed" in out
