"""Global (wavefront) archives in the PyTorch port on the CPU against the
JAX reference: anchored and anchor-free, Mode 2 and Mode 1, origins past
2^31. The same rows byte for byte, the same `decoded_blocks_last`,
`launch_rounds_last` and window schedule, the same `last_window_rows`
block ids, and the same window guards."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import decoder as rdec
from repro.core import encoder as renc
from repro.core import format as rfmt
from repro.kernels import ref as rref
from repro_torch.core import decoder as pdec
from repro_torch.core import format as pfmt
from repro_torch.kernels import ref as pref
from test_torch_decoder import port_archive
from test_torch_kernels import deep_chain_payload
from test_torch_stream import mixed_payload

BS = 4096


@pytest.fixture(scope="module")
def corpus():
    from repro.data.fastq import make_fastq
    return make_fastq("platinum", n_reads=250, seed=3)


def pair(a):
    return (rdec.Decoder(a, backend="ref"),
            pdec.Decoder(port_archive(a), device="cpu"))


def same(r, p, fn, *args, **kw):
    """Call `fn` on both decoders: equal rows and equal counters."""
    want = np.asarray(getattr(r, fn)(*args, **kw))
    got = getattr(p, fn)(*args, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert p.decoded_blocks_last == r.decoded_blocks_last
    assert p.launch_rounds_last == r.launch_rounds_last
    return got


def src_rows(a, raw: np.ndarray, sel) -> list:
    return [raw[int(a.block_start[b]) - int(a.block_start[0]):][
        :int(a.block_len[b])] for b in sel]


def check_source(a, raw, rows, sel):
    for i, want in enumerate(src_rows(a, raw, sel)):
        np.testing.assert_array_equal(rows[i, :want.size], want)


# ------------------------------------------------------------- roundtrip
@pytest.mark.parametrize("interval", [1, 4, 0])
@pytest.mark.parametrize("entropy", ["rans", "raw"])
def test_anchor_roundtrip_sweep(corpus, interval, entropy):
    a = renc.encode(corpus, block_size=BS, mode="global", entropy=entropy,
                    anchor_interval=interval)
    r, p = pair(a)
    np.testing.assert_array_equal(p.da.anchors, a.anchors)
    assert p.da.anchor_interval == a.anchor_interval
    np.testing.assert_array_equal(p.block_rounds, r.block_rounds)
    got = p.decode_all()
    assert got.tobytes() == corpus
    np.testing.assert_array_equal(got, r.decode_all())
    assert p.decoded_blocks_last == r.decoded_blocks_last
    assert p.launch_rounds_last == r.launch_rounds_last
    assert p.decode_all(chunk_blocks=3, verify=True).tobytes() == corpus


def test_every_block_decodes_through_its_window(corpus):
    a = renc.encode(corpus, block_size=BS, mode="global", anchor_interval=4)
    r, p = pair(a)
    raw = np.frombuffer(corpus, np.uint8)
    for b in range(a.n_blocks):
        rows = same(r, p, "decode_blocks", np.array([b]))
        check_source(a, raw, rows, [b])
        assert p.decoded_blocks_last <= 4 + 1


def test_point_query_and_decode_from_anchor(corpus):
    interval = 4
    a = renc.encode(corpus, block_size=BS, mode="global",
                    anchor_interval=interval)
    assert a.n_blocks > interval + 2
    r, p = pair(a)
    raw = np.frombuffer(corpus, np.uint8)
    b = a.n_blocks - 2
    same(r, p, "decode_blocks", np.array([b]))
    assert p.decoded_blocks_last <= interval + 1 < a.n_blocks
    for first, last in ((b, b), (b - 2, b + 1), (0, 0), (3, 9)):
        rows = same(r, p, "decode_from_anchor", first, last)
        assert rows.shape == (last - first + 1, BS)
        check_source(a, raw, rows, range(first, last + 1))
    same(r, p, "decode_from_anchor", 5, 6, verify=True)
    sel = np.array([1, b, 5])
    check_source(a, raw, same(r, p, "decode_blocks", sel), sel)
    assert p.decoded_blocks_last < a.n_blocks
    with pytest.raises(IndexError):
        p.decode_from_anchor(3, a.n_blocks)


def test_decode_from_anchor_ra_rejected(corpus):
    a = renc.encode(corpus[:30_000], block_size=BS, mode="ra")
    with pytest.raises(ValueError, match="global"):
        pair(a)[1].decode_from_anchor(0, 0)


def test_window_rows_collected_for_the_cache(corpus):
    """`collect_window_rows` hands each materialized window to the cache
    co-install: the same windows (first block id, rows) as the
    reference, in both modes."""
    a = renc.encode(corpus, block_size=BS, mode="global", anchor_interval=4)
    r, p = pair(a)
    sel = np.array([11, 2, 7, 2])
    for fn in ("decode_blocks", "decode_blocks_host_entropy"):
        r.collect_window_rows = p.collect_window_rows = True
        same(r, p, fn, sel)
        assert [f for f, _ in p.last_window_rows] == \
            [f for f, _ in r.last_window_rows] == [0, 4, 8]
        for (_, pw), (_, rw) in zip(p.last_window_rows, r.last_window_rows):
            np.testing.assert_array_equal(pw.numpy(), np.asarray(rw))
    r.collect_window_rows = p.collect_window_rows = False
    same(r, p, "decode_blocks", sel)
    assert p.last_window_rows == [] == r.last_window_rows


# --------------------------------------------------------- depth and schedule
@pytest.mark.parametrize("interval", [0, 4])
@pytest.mark.parametrize("entropy", ["rans", "raw"])
def test_depth_bounded_and_legacy_match_reference(interval, entropy):
    """Deep-chain payloads: depth-bounded windows, the legacy early-exit
    resolver of a depth-free archive and Mode 1 give the reference's rows
    and launches."""
    raw = deep_chain_payload(40_000)
    a = renc.encode(raw.tobytes(), block_size=BS, mode="global",
                    entropy=entropy, anchor_interval=interval)
    assert a.max_depth > 1
    sel = np.array([a.n_blocks - 1, 1, a.n_blocks // 2])
    for arc in (a, dataclasses.replace(a, block_depth=None)):
        r, p = pair(arc)
        rows = same(r, p, "decode_blocks", np.arange(a.n_blocks))
        assert rows.reshape(-1)[:raw.size].tobytes() == raw.tobytes()
        same(r, p, "decode_blocks", sel)
        same(r, p, "decode_blocks_host_entropy", sel)
    assert p.da.max_depth is None and p.launch_rounds_last[0] is None


def test_v2_depth_free_archive_still_seeks_by_window():
    raw = deep_chain_payload(30_000)
    a = renc.encode(raw.tobytes(), block_size=BS, mode="global",
                    anchor_interval=4)
    buf = rfmt.serialize(a)
    v2 = rfmt.MAGIC_V2 + buf[8:-(8 + 4 * a.n_blocks)]
    r = rdec.Decoder(rfmt.deserialize(v2), backend="ref")
    p = pdec.Decoder(pfmt.deserialize(v2), device="cpu")
    assert p.da.max_depth is None and p.block_rounds is None
    same(r, p, "decode_blocks", np.array([a.n_blocks - 1]))
    assert p.decoded_blocks_last <= 4 + 1


@pytest.mark.parametrize("interval", [2, 0])
@pytest.mark.parametrize("entropy", ["rans", "raw"])
def test_bucketed_global_decode_matches_reference(interval, entropy):
    data = mixed_payload(BS)
    a = renc.encode(data, block_size=BS, mode="global", entropy=entropy,
                    anchor_interval=interval)
    r, p = pair(a)
    np.testing.assert_array_equal(p.block_rounds, r.block_rounds)
    assert p.multi_bucket == r.multi_bucket
    rows = same(r, p, "decode_blocks", np.arange(a.n_blocks))
    assert rows.reshape(-1)[:len(data)].tobytes() == data
    sel = np.array([a.n_blocks - 1, 0, a.n_blocks // 2])
    same(r, p, "decode_blocks", sel)
    same(r, p, "decode_blocks_host_entropy", sel)


def test_global_schedule_is_per_window():
    data = mixed_payload(BS)
    a = renc.encode(data, block_size=BS, mode="global", anchor_interval=2)
    p = pair(a)[1]
    win_of = np.searchsorted(a.anchors, np.arange(a.n_blocks), "right") - 1
    for w in np.unique(win_of):
        blocks = np.flatnonzero(win_of == w)
        assert np.unique(p.block_rounds[blocks]).size == 1
        assert int(p.block_rounds[blocks][0]) >= int(
            a.block_depth[blocks].max())


# ------------------------------------------------------ origins past 2^31
BIG = 2**31


@pytest.mark.parametrize("entropy", ["rans", "raw"])
def test_anchored_origin_past_2gib(entropy):
    """Windows starting past 2^31 rebase modulo 2^32 in int64: exact, and
    equal to the reference's i32 wraparound."""
    raw = deep_chain_payload(40_000)
    origin = BIG + 3 * BS + 17
    a = renc.encode(raw.tobytes(), block_size=BS, mode="global",
                    entropy=entropy, anchor_interval=4, origin=origin)
    assert int(a.block_start[0]) == origin
    r, p = pair(a)
    rows = same(r, p, "decode_blocks", np.arange(a.n_blocks))
    assert rows.reshape(-1)[:raw.size].tobytes() == raw.tobytes()
    sel = np.array([a.n_blocks - 1, 2])
    check_source(a, raw, same(r, p, "decode_blocks", sel), sel)
    assert p.decoded_blocks_last < a.n_blocks
    same(r, p, "decode_blocks_host_entropy", sel)


@pytest.mark.parametrize("origin", [BIG + 999, 2**32 - 2**13 + 17])
def test_anchor_free_origin_past_2gib(origin):
    raw = deep_chain_payload(30_000)
    a = renc.encode(raw.tobytes(), block_size=BS, mode="global",
                    origin=origin)
    r, p = pair(a)
    rows = same(r, p, "decode_blocks", np.arange(a.n_blocks))
    assert rows.reshape(-1)[:raw.size].tobytes() == raw.tobytes()


def test_wraparound_rebase_equals_i32_subtraction():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 1000, dtype=np.int64)
    base = rng.integers(0, 2**32, 1000, dtype=np.int64)
    got = pdec._wrap_i32(torch.from_numpy(x) - torch.from_numpy(base))
    want = (x - base + 2**31) % 2**32 - 2**31
    np.testing.assert_array_equal(got.numpy(), want)


def test_window_guards_match_reference():
    for guard in (rdec._check_window_bytes, pdec._check_window_bytes):
        with pytest.raises(ValueError, match="2 GiB"):
            guard(0, 2**20, BS)
        guard(0, 2**18, BS)
    a = renc.encode(deep_chain_payload(20_000).tobytes(), block_size=BS,
                    mode="global")
    big = dataclasses.replace(port_archive(a), raw_size=BIG)
    with pytest.raises(ValueError, match="anchor_interval"):
        pdec.to_device(big, "cpu")


# ----------------------------------------------- the plain global resolve
@pytest.mark.parametrize("slab", [None, BS, 3 * BS],
                         ids=["one_slab", "row_slabs", "uneven_slabs"])
def test_global_resolve_matches_reference_oracle(corpus, slab, monkeypatch):
    """`ref.lz77_decode_global_ref` against the JAX oracle on a rebased
    window's command columns, at the recorded rounds and early exit, with
    the pointer expansion in one slab or in several."""
    import jax.numpy as jnp
    if slab is not None:
        monkeypatch.setattr(pref, "EXPAND_SLAB", slab)
    a = renc.encode(corpus, block_size=BS, mode="global", anchor_interval=4)
    first, last = 4, 7
    wsel = np.arange(first, last + 1)
    st = rdec._entropy_decode_host(a, wsel)
    nc = a.n_cmds[wsel]
    C = int(a.n_cmds.max())
    cols = dict(
        lit_lens=rdec._u16_from_planes(st["commands"], jnp.asarray(nc), C),
        match_lens=rdec._u16_from_planes(st["lengths"], jnp.asarray(nc), C),
        offsets=rdec._u64lo_from_planes(st["offsets"], jnp.asarray(nc), C)
        - int(a.block_start[first]))
    bstart = (a.block_start[wsel] - a.block_start[first]).astype(np.int32)
    lit_base = np.arange(wsel.size, dtype=np.int32) * BS
    for rounds in (int(a.block_depth[wsel].max()), None):
        want = rref.lz77_decode_global_ref(
            **cols, n_cmds=jnp.asarray(nc), literals=st["literals"],
            lit_base=jnp.asarray(lit_base), block_start=jnp.asarray(bstart),
            block_len=jnp.asarray(a.block_len[wsel]), out_size=BS,
            total_size=wsel.size * BS, n_rounds=rounds)
        got = pref.lz77_decode_global_ref(
            **{k: torch.from_numpy(np.array(v)) for k, v in cols.items()},
            n_cmds=torch.from_numpy(nc),
            literals=torch.from_numpy(np.array(st["literals"])),
            lit_base=torch.from_numpy(lit_base),
            block_start=torch.from_numpy(bstart),
            block_len=torch.from_numpy(a.block_len[wsel]), out_size=BS,
            total_size=wsel.size * BS, n_rounds=rounds)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------- query plane
def test_plan_anchor_window_math(corpus):
    """`DecodePlan.anchor_windows`/`anchor_decode_blocks` equal the
    reference's and predict what the execution decodes."""
    from repro.api import GenomicArchive as RGA
    from repro_torch.api import GenomicArchive as PGA
    rga = RGA.from_bytes(corpus, block_size=BS, mode="global",
                         anchor_interval=4, backend="ref")
    pga = PGA.from_bytes(corpus, block_size=BS, mode="global",
                         anchor_interval=4, device="cpu")
    anchors = pga.store.decoder.da.anchors
    b = pga.store.decoder.da.n_blocks - 2
    rp = rga.planner.plan_spans(np.array([b * BS]), np.array([100]))
    pp = pga.planner.plan_spans(np.array([b * BS]), np.array([100]))
    assert [(f, l, i.tolist()) for f, l, i in pp.anchor_windows(anchors)] \
        == [(f, l, i.tolist()) for f, l, i in rp.anchor_windows(anchors)]
    assert pp.anchor_decode_blocks(anchors) <= 4 + 1
    pga.executor.run(pp)
    assert pp.anchor_decode_blocks(anchors) == \
        pga.store.decoder.decoded_blocks_last
    last = pp.anchor_windows(anchors)[0][1]
    assert pp.anchor_decode_blocks(np.zeros(0, np.int64)) == last + 1


def test_query_plane_global_anchored_end_to_end(corpus):
    """Point queries through the facade over an anchored archive decode
    one window, and a repeat is a pure cache hit."""
    from repro_torch.api import GenomicArchive
    from repro_torch.core.index import parse_fastq_records
    raw = np.frombuffer(corpus, np.uint8)
    ga = GenomicArchive.from_bytes(corpus, block_size=BS, mode="global",
                                   anchor_interval=4, cache_blocks=8,
                                   device="cpu")
    d = ga.store.decoder
    lo = (d.da.n_blocks - 2) * BS
    np.testing.assert_array_equal(ga[lo:lo + 100], raw[lo:lo + 100])
    assert d.decoded_blocks_last <= 4 + 1
    launches = ga.cache_info()["decode_launches"]
    np.testing.assert_array_equal(ga[lo:lo + 100], raw[lo:lo + 100])
    assert ga.cache_info()["decode_launches"] == launches
    assert ga.cache_info()["hits"] > 0
    starts, _ = parse_fastq_records(corpus)
    np.testing.assert_array_equal(ga[7], raw[starts[7]:starts[8]])
