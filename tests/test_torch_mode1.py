"""Mode 1 (host entropy, device match) in the PyTorch port on the CPU
against the JAX reference: the host-decoded stream rows, the rows of
`decode_blocks_host_entropy`, `decode_range`/`decode_all`/`fetch_reads`
with `mode2=False`, and the counters, byte for byte. "ra" Mode 1 runs the
LZ77 match kernel's wrapper on the uploaded streams; global Mode 1 the
window resolve."""
import dataclasses

import numpy as np
import pytest

from repro.core import decoder as rdec
from repro.core import encoder as renc
from repro.core.index import ReadIndex as RIndex
from repro.core.residency import CompressedResidentStore as RStore
from repro_torch.core import decoder as pdec
from repro_torch.core.format import S_LITERALS
from repro_torch.core.index import ReadIndex as PIndex
from repro_torch.core.residency import CompressedResidentStore as PStore
from repro_torch.kernels import ops
from test_torch_decoder import port_archive
from test_torch_global import pair, same

BS = 4096


@pytest.fixture(scope="module")
def data():
    from repro.data.fastq import make_fastq
    return make_fastq("noisy", n_reads=220, seed=5)


@pytest.mark.parametrize("mode,interval,entropy", [
    ("ra", 0, "rans"), ("ra", 0, "raw"), ("global", 4, "rans"),
    ("global", 0, "raw")])
def test_host_streams_equal_reference(data, mode, interval, entropy):
    """The host entropy stage's padded stream rows (8 offset planes for
    global archives) equal the reference's."""
    a = renc.encode(data, block_size=BS, mode=mode, entropy=entropy,
                    anchor_interval=interval)
    sel = np.array([3, 0, a.n_blocks - 1])
    want = rdec._entropy_decode_host(a, sel)
    got = pdec._entropy_decode_host(port_archive(a), sel,
                                    int(a.n_cmds.max()))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("mode,interval,entropy", [
    ("ra", 0, "rans"), ("ra", 0, "raw"), ("global", 4, "rans"),
    ("global", 0, "rans")])
def test_mode1_equals_mode2_and_reference(data, mode, interval, entropy):
    a = renc.encode(data, block_size=BS, mode=mode, entropy=entropy,
                    anchor_interval=interval)
    r, p = pair(a)
    for sel in (np.arange(a.n_blocks), np.array([11, 2, 7, 2])):
        m1 = same(r, p, "decode_blocks_host_entropy", sel)
        np.testing.assert_array_equal(p.decode_blocks(sel).numpy(), m1)
    assert p.decoded_blocks_last < a.n_blocks or not interval


def test_mode1_runs_the_match_wrapper_not_rans(monkeypatch):
    """"ra" Mode 1 goes through `ops.lz77_decode_planes` (uncounted on the
    CPU, where it takes the plain version) and never the rANS wrapper."""
    from repro.data.fastq import make_fastq
    d = make_fastq("platinum", n_reads=60, seed=2)
    p = pdec.Decoder(port_archive(renc.encode(d, block_size=2048)),
                     device="cpu")
    calls = []
    for name, tag in (("lz77_decode_planes", "lz"),
                      ("rans_decode_streams", "rans")):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _t=tag, **k: (
            calls.append(_t), _r(*a, **k))[1])
    rows = p.decode_blocks_host_entropy(np.arange(3))
    assert calls == ["lz"] * len(p.launch_rounds_last)
    assert rows.numpy().reshape(-1)[:3 * 2048].tobytes() == d[:3 * 2048]


def test_mode1_verify_clean_and_corrupted(data):
    a = renc.encode(data, block_size=BS)
    r, p = pair(a)
    sel = np.arange(a.n_blocks)
    same(r, p, "decode_blocks_host_entropy", sel, verify=True)
    assert p.decode_all(mode2=False, verify=True).tobytes() == data
    pa = port_archive(a)
    pa.words[int(pa.word_off[2, S_LITERALS]) + 3] ^= 0xA5
    bad = pdec.Decoder(pa, device="cpu")
    with pytest.raises(pdec.BlockDigestError, match="block 2"):
        bad.decode_blocks_host_entropy(np.array([2]), verify=True)
    with pytest.raises(pdec.BlockDigestError, match="block 2"):
        bad.decode_all(mode2=False, chunk_blocks=3, verify=True)


def test_mode1_range_decode_equals_slice(data):
    a = renc.encode(data, block_size=BS)
    r, p = pair(a)
    for lo, hi in ((0, 100), (5000, 9000), (BS, 2 * BS), (1, 2),
                   (len(data) - 100, len(data))):
        for d in (r, p):
            d.decoded_blocks_last, d.launch_rounds_last = -1, ["unset"]
        got = p.decode_range(lo, hi, mode2=False)
        assert got.tobytes() == data[lo:hi]
        np.testing.assert_array_equal(got, r.decode_range(lo, hi,
                                                          mode2=False))
        assert p.decoded_blocks_last == r.decoded_blocks_last
        assert p.launch_rounds_last == r.launch_rounds_last


@pytest.mark.parametrize("mode,interval", [("ra", 0), ("global", 4)])
def test_mode1_chunked_equals_whole(data, mode, interval):
    a = renc.encode(data, block_size=BS, mode=mode,
                    anchor_interval=interval)
    r, p = pair(a)
    got = p.decode_all(chunk_blocks=3, mode2=False)
    assert got.tobytes() == data
    np.testing.assert_array_equal(got, r.decode_all(chunk_blocks=3,
                                                    mode2=False))
    assert p.decoded_blocks_last == r.decoded_blocks_last
    assert p.launch_rounds_last == r.launch_rounds_last
    assert p.decode_all(mode2=False).tobytes() == data


def test_mode1_position_invariance_and_legacy(data):
    a = renc.encode(data, block_size=BS)
    for arc in (a, dataclasses.replace(a, block_depth=None)):
        r, p = pair(arc)
        alone = same(r, p, "decode_blocks_host_entropy", np.array([7]))[0]
        in_range = same(r, p, "decode_blocks_host_entropy",
                        np.arange(5, 12))[2]
        np.testing.assert_array_equal(alone, in_range)
    assert p.launch_rounds_last == [None]


@pytest.mark.parametrize("mode,interval", [("ra", 0), ("global", 4)])
def test_mode1_fetch_reads_match_reference(data, mode, interval):
    a = renc.encode(data, block_size=BS, mode=mode,
                    anchor_interval=interval)
    ridx = RIndex.build(data, BS)
    rs = RStore(a, ridx, backend="ref")
    ps = PStore(port_archive(a), PIndex(starts=ridx.starts.copy(),
                                        block_size=BS), device="cpu")
    ids = np.random.default_rng(1).integers(0, ridx.n_reads, 9)
    for verify in (False, True):
        want = rs.fetch_reads(ids, mode2=False, verify=verify)
        got = ps.fetch_reads(ids, mode2=False, verify=verify)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert ps.decoder.decoded_blocks_last == \
            rs.decoder.decoded_blocks_last
        assert ps.decoder.launch_rounds_last == rs.decoder.launch_rounds_last
    out, lens = got
    for i, rid in enumerate(ids):
        lo, hi, _ = ridx.lookup(int(rid))
        assert out[i, :int(lens[i])].numpy().tobytes() == data[lo:hi]
