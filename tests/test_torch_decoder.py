"""The PyTorch port's Mode 2 "ra" `Decoder` on the CPU against the JAX
reference `Decoder(backend="ref")`: the same rows, the same depth-bucketed
launches (`launch_rounds_last`) and the same materialized block counts
(`decoded_blocks_last`), byte for byte, for rans and raw archives. The
archive crosses over as the reference's serialized bytes."""
import dataclasses

import numpy as np
import pytest

from repro.core import decoder as rdec
from repro.core import encoder as renc
from repro.core import format as rfmt
from repro_torch.core import decoder as pdec
from repro_torch.core import format as pfmt
from test_torch_kernels import deep_chain_payload


def port_archive(a):
    return pfmt.deserialize(rfmt.serialize(a))


def _payload(kind, fastq_noisy):
    if kind == "deep":                  # several pow2 depth buckets
        raw = deep_chain_payload(24_000, seg=300, seed=3)
        rng = np.random.default_rng(4)
        # a random tail keeps its blocks shallow: depth-bucketed launches
        return np.concatenate([raw, rng.integers(0, 256, 9000,
                                                 dtype=np.uint8)]).tobytes()
    return fastq_noisy[:30_000]


@pytest.fixture(scope="module", params=[("fastq", 1024, "rans"),
                                        ("fastq", 2048, "raw"),
                                        ("deep", 2048, "rans")],
                ids=lambda p: "-".join(map(str, p)))
def pair(request, fastq_noisy):
    kind, block, entropy = request.param
    data = _payload(kind, fastq_noisy)
    a = renc.encode(data, block_size=block, entropy=entropy)
    return (data, a, rdec.Decoder(a, backend="ref"),
            pdec.Decoder(port_archive(a), device="cpu"))


def _reset_counters(*decoders):
    for d in decoders:
        d.launch_rounds_last, d.decoded_blocks_last = ["unset"], -1


def _same_counters(r, p):
    assert p.launch_rounds_last == r.launch_rounds_last
    assert p.decoded_blocks_last == r.decoded_blocks_last


def test_decode_blocks_matches_reference(pair):
    _, a, r, p = pair
    rng = np.random.default_rng(7)
    for sel in (np.arange(a.n_blocks), rng.integers(0, a.n_blocks, 5),
                np.array([a.n_blocks - 1, 0, 0, 3])):
        want = np.asarray(r.decode_blocks(sel))
        got = p.decode_blocks(sel)
        np.testing.assert_array_equal(got.numpy(), want)
        _same_counters(r, p)
    sel = rng.integers(0, a.n_blocks, 6)
    np.testing.assert_array_equal(
        p.decode_blocks(sel, pad_groups=False).numpy(),
        np.asarray(r.decode_blocks(sel, pad_groups=False)))
    _same_counters(r, p)


def test_deep_archive_launches_one_match_per_bucket(pair):
    data, a, r, p = pair
    if p.multi_bucket:
        p.decode_blocks(np.arange(a.n_blocks))
        assert len(p.launch_rounds_last) > 1
        assert p.launch_rounds_last == sorted(set(p.launch_rounds_last))


def test_decode_all_matches_reference(pair):
    data, a, r, p = pair
    src = np.frombuffer(data, np.uint8)
    got = p.decode_all(chunk_blocks=5, verify=True)
    np.testing.assert_array_equal(got, r.decode_all(chunk_blocks=5,
                                                    verify=True))
    np.testing.assert_array_equal(got, src)
    _same_counters(r, p)
    np.testing.assert_array_equal(p.decode_all(), src)


def test_decode_range_matches_reference(pair):
    data, a, r, p = pair
    for lo, hi in ((0, 1), (100, 3000), (a.block_size - 5, a.block_size + 7),
                   (len(data) - 10, len(data)), (5, 5)):
        _reset_counters(r, p)     # the fused path leaves them untouched
        got = p.decode_range(lo, hi)
        np.testing.assert_array_equal(got, r.decode_range(lo, hi))
        assert got.tobytes() == data[lo:hi]
        _same_counters(r, p)


def test_legacy_depth_free_archive_early_exits(fastq_noisy):
    data = fastq_noisy[:12_000]
    a = dataclasses.replace(renc.encode(data, block_size=2048),
                            block_depth=None)
    r = rdec.Decoder(a, backend="ref")
    p = pdec.Decoder(port_archive(a), device="cpu")
    assert p.da.max_depth is None and p.block_rounds is None
    sel = np.array([3, 1, 4, 1, 5])
    np.testing.assert_array_equal(p.decode_blocks(sel).numpy(),
                                  np.asarray(r.decode_blocks(sel)))
    assert p.launch_rounds_last == r.launch_rounds_last == [None]
    assert p.decode_all().tobytes() == data


def test_verify_raises_on_flipped_word(fastq_noisy):
    a = renc.encode(fastq_noisy[:12_000], block_size=2048)
    pa = port_archive(a)
    bad = 3
    w = int(pa.word_off[bad, 0]) + 9
    pa.words[w] ^= 0x5A5A
    p = pdec.Decoder(pa, device="cpu")
    with pytest.raises(pdec.BlockDigestError, match=f"block {bad} "):
        p.decode_blocks(np.arange(a.n_blocks), verify=True)
    with pytest.raises(pdec.BlockDigestError):
        p.decode_all(chunk_blocks=2, verify=True)
    # the unverified decode returns the damaged block, the rest are intact
    rows = p.decode_blocks(np.array([bad - 1, bad + 1])).numpy()
    want = np.asarray(rdec.Decoder(a, backend="ref").decode_blocks(
        np.array([bad - 1, bad + 1])))
    np.testing.assert_array_equal(rows, want)


def test_file_digest_mismatch_raises(fastq_noisy):
    pa = port_archive(renc.encode(fastq_noisy[:5000], block_size=2048))
    pa.file_fnv ^= 1
    with pytest.raises(pdec.BlockDigestError, match="file digest"):
        pdec.Decoder(pa, device="cpu").decode_all(verify=True)


def test_fnv_rows_match_host_digest(fastq_noisy):
    import torch
    data = np.frombuffer(fastq_noisy[:4099], np.uint8)
    rows = torch.zeros((2, 4104), dtype=torch.uint8)
    rows[0, :4099] = torch.from_numpy(data.copy())
    rows[1, :13] = torch.from_numpy(data[:13].copy())
    hi, lo = pdec._fnv_rows_core(rows, torch.tensor([4099, 13]))
    got = (hi.numpy().astype(np.uint64) << np.uint64(32)) | \
        lo.numpy().astype(np.uint64)
    assert int(got[0]) == pfmt.fnv1a64_u64_stride(data)
    assert int(got[1]) == pfmt.fnv1a64_u64_stride(data[:13])


def test_unported_paths_raise(fastq_noisy):
    """Only the self-healing failure modes stay unported; Mode 1 and
    global archives decode like the reference."""
    data = fastq_noisy[:5000]
    ra = renc.encode(data, block_size=2048)
    p = pdec.Decoder(port_archive(ra), device="cpu")
    for how in ("repair", "partial"):
        with pytest.raises(NotImplementedError, match="self-healing"):
            p.decode_blocks([0], verify=True, on_error=how)
        with pytest.raises(NotImplementedError, match="self-healing"):
            p.decode_all(on_error=how)
    with pytest.raises(IndexError):
        p.decode_blocks([ra.n_blocks])
    np.testing.assert_array_equal(
        p.decode_blocks_host_entropy([0]).numpy(),
        np.asarray(rdec.Decoder(ra, backend="ref").decode_blocks([0])))
    g = renc.encode(data, block_size=2048, mode="global")
    assert pdec.Decoder(port_archive(g), device="cpu").decode_all(
        mode2=False).tobytes() == data
