"""The PyTorch port's device-resident block cache on the CPU against the
JAX reference: the same CachePlans and slot maps under every single-card
policy, `cache_info()` equal to the reference's after every call, one
decode call per miss set, the same bytes, and the anchor-window
co-install of global archives."""
import numpy as np
import pytest

from repro.api import cache as rcache
from repro.core import encoder as renc
from repro.core.index import ReadIndex as RIndex
from repro.core.residency import CompressedResidentStore as RStore
from repro_torch.api import cache as pcache
from repro_torch.api.plan import CachePlan, split_cache_hits
from repro_torch.core.index import ReadIndex as PIndex
from repro_torch.core.residency import CompressedResidentStore as PStore
from test_torch_decoder import port_archive
from test_torch_kernels import deep_chain_payload
from test_torch_stream import mixed_payload

BS = 4096


@pytest.fixture(scope="module")
def corpus():
    from repro.data.fastq import make_fastq
    data = make_fastq("platinum", n_reads=250, seed=1)
    a = renc.encode(data, block_size=BS)
    return a, RIndex.build(data, BS), np.frombuffer(data, np.uint8)


def stores(corpus, **kw):
    a, idx, _ = corpus
    pidx = PIndex(starts=idx.starts.copy(), block_size=BS)
    return (RStore(a, idx, backend="ref", **kw),
            PStore(port_archive(a), pidx, device="cpu", **kw))


def caches(n_blocks, capacity, policy):
    """(reference cache, port cache) with fresh policies of one spec."""
    def make(mod):
        pol = policy(mod) if callable(policy) else policy
        return mod.BlockCache(capacity, BS, n_blocks, policy=pol,
                              **({} if mod is rcache else {"device": "cpu"}))
    return make(rcache), make(pcache)


def same_plan(rc, pc, uniq):
    rp, pp = rc.plan(uniq), pc.plan(uniq)
    assert isinstance(pp, CachePlan)
    for f in ("uniq", "src_is_miss", "src_idx", "miss_blocks",
              "install_slots"):
        np.testing.assert_array_equal(getattr(pp, f), getattr(rp, f))
    for f in ("n_hits", "n_misses", "n_installed", "n_evicted"):
        assert getattr(pp, f) == getattr(rp, f)
    np.testing.assert_array_equal(pc.slot_of, rc.slot_of)
    assert pc.info() == rc.info()
    return pp


def zipf_ids(rng, n, size, s=1.1):
    p = 1.0 / np.arange(1, n + 1) ** s
    return rng.choice(n, size=size, p=p / p.sum())


def same_fetch(rs, ps, ids, **kw):
    r_out, p_out = rs.fetch_reads(ids, **kw), ps.fetch_reads(ids, **kw)
    for r, p in zip(r_out, p_out):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    assert ps.cache_info() == rs.cache_info()
    assert (ps.cache_hits, ps.cache_misses) == (rs.cache_hits,
                                                rs.cache_misses)
    return p_out


# ------------------------------------------------------------- CachePlan
def test_cache_plan_split_vectorized(corpus):
    rc, pc = caches(corpus[0].n_blocks, 4, "lru")
    cp = same_plan(rc, pc, np.array([3, 7, 9]))
    assert cp.n_hits == 0 and cp.n_misses == 3 and cp.n_installed == 3
    cp2 = same_plan(rc, pc, np.array([7, 9, 11]))
    assert cp2.n_hits == 2 and cp2.miss_blocks.tolist() == [11]
    hit, slots = split_cache_hits(np.array([3, 5]), pc.slot_of)
    assert hit.tolist() == [True, False] and slots[0] >= 0


def test_capacity_overflow_decodes_without_install(corpus):
    rc, pc = caches(corpus[0].n_blocks, 2, "lru")
    cp = same_plan(rc, pc, np.arange(6))
    assert cp.n_misses == 6 and cp.n_installed == 2 and pc.resident == 2


def test_invalidate_and_reset_match_reference(corpus):
    """`invalidate` frees slots without touching the buffer and counts
    evictions; `reset` drops every resident block but keeps counters."""
    rc, pc = caches(corpus[0].n_blocks, 4, "lru")
    same_plan(rc, pc, np.array([1, 3, 5, 7]))
    for c in (rc, pc):
        assert c.invalidate(np.array([3, 7, 9, -1, 10**6])) == 2
    np.testing.assert_array_equal(pc.slot_of, rc.slot_of)
    assert pc.info() == rc.info() and pc.resident == 2
    same_plan(rc, pc, np.array([3, 5, 8]))
    for c in (rc, pc):
        c.reset()
    assert pc.info() == rc.info() and pc.resident == 0
    assert pc.buf.shape == (4, BS) and not pc.buf.any()
    same_plan(rc, pc, np.array([5]))


# --------------------------------------------------------------- policies
@pytest.mark.parametrize("policy", [
    "lru", "freq", "tinylfu",
    lambda m: m.PinRangePolicy(0, 1),
    lambda m: m.FrequencyPolicy(3),
    lambda m: m.TinyLFUPolicy(sample_factor=2),
    lambda m: m.PinRangePolicy(2, 4, inner=m.TinyLFUPolicy())],
    ids=["lru", "freq", "tinylfu", "pin", "freq3", "tinylfu2", "pin-tlfu"])
def test_policies_plan_like_the_reference(corpus, policy):
    """A seeded stream of covering sets through both caches: every plan,
    slot map and counter equal after every step."""
    n = corpus[0].n_blocks
    rc, pc = caches(n, 3, policy)
    rng = np.random.default_rng(5)
    for _ in range(40):
        same_plan(rc, pc, np.unique(zipf_ids(rng, n, rng.integers(1, 5))))


def test_lru_evicts_least_recent(corpus):
    cache = pcache.BlockCache(2, BS, corpus[0].n_blocks, device="cpu")
    for b in (0, 1, 0):
        cache.plan(np.array([b]))
    assert cache.plan(np.array([2])).n_evicted == 1
    assert cache.slot_of[1] < 0 and cache.slot_of[0] >= 0


def test_frequency_policy_blocks_one_hit_wonders(corpus):
    cache = pcache.BlockCache(2, BS, corpus[0].n_blocks, device="cpu",
                              policy=pcache.FrequencyPolicy(2))
    cache.plan(np.array([0]))
    assert cache.resident == 0
    cache.plan(np.array([0]))
    assert cache.slot_of[0] >= 0
    for b in range(5, 12):
        cache.plan(np.array([0, b]))
    assert cache.slot_of[0] >= 0


def test_pin_range_and_make_policy(corpus):
    cache = pcache.BlockCache(2, BS, corpus[0].n_blocks, device="cpu",
                              policy=pcache.PinRangePolicy(0, 1))
    cache.plan(np.array([0]))
    for b in range(1, 8):
        cache.plan(np.array([b]))
    assert cache.slot_of[0] >= 0
    with pytest.raises(ValueError, match="inverted"):
        pcache.PinRangePolicy(5, 3)
    with pytest.raises(ValueError, match="unknown cache policy"):
        pcache.make_policy("mru")
    assert isinstance(pcache.make_policy("tinylfu"), pcache.TinyLFUPolicy)
    p = pcache.LRUPolicy()
    assert pcache.make_policy(p) is p
    with pytest.raises(ValueError, match="positive"):
        pcache.BlockCache(0, BS, 4, device="cpu")
    # the per-shard cache needs one policy instance a shard, in both
    for mod in (rcache, pcache):
        with pytest.raises(TypeError, match="PER shard"):
            mod.ShardedBlockCache(4, BS, 4, None, policy=mod.LRUPolicy())


def test_frequency_sketch_saturates_and_halves():
    sk, rk = pcache.FrequencySketch(64, n_hash=4), \
        rcache.FrequencySketch(64, n_hash=4)
    keys = np.random.default_rng(2).integers(0, 10_000, 500)
    for k in (sk, rk):
        k.add(np.full(40, 7))
    assert int(sk.estimate(np.array([7]))[0]) == 15
    assert int(sk.estimate(np.array([9]))[0]) == 0
    for k in (sk, rk):
        k.add(np.array([9, 9, 9]))
        k.halve()
    assert sk.halvings == 1
    assert int(sk.estimate(np.array([7]))[0]) == 7
    assert int(sk.estimate(np.array([9]))[0]) == 1
    for k in (sk, rk):
        k.add(keys)
    np.testing.assert_array_equal(sk.table, rk.table)
    np.testing.assert_array_equal(sk.estimate(keys), rk.estimate(keys))
    with pytest.raises(ValueError, match="positive"):
        pcache.FrequencySketch(0)
    with pytest.raises(ValueError, match="positive"):
        pcache.TinyLFUPolicy(sample_factor=0)


def test_tinylfu_aging_and_flash_crowd(corpus):
    n = corpus[0].n_blocks
    pol = pcache.TinyLFUPolicy(sample_factor=64)
    cache = pcache.BlockCache(2, BS, n, policy=pol, device="cpu")
    for _ in range(5):
        cache.plan(np.array([0, 1]))
    cache.plan(np.array([4]))
    cache.plan(np.array([4]))
    assert cache.slot_of[4] < 0
    for _ in range(4):
        pol.record(np.full(pol.window, 2))
    assert int(pol.estimate(np.array([0, 1])).max()) == 0
    cache.plan(np.array([4]))
    assert cache.slot_of[4] >= 0
    pol = pcache.TinyLFUPolicy(sample_factor=2)
    cache = pcache.BlockCache(2, BS, n, policy=pol, device="cpu")
    for _ in range(6):
        cache.plan(np.array([0, 1]))
    for k in range(1, 17):
        cache.plan(np.array([4]))
        if cache.slot_of[4] >= 0:
            break
    assert cache.slot_of[4] >= 0 and k <= 8


# ------------------------------------------------- stores, byte for byte
@pytest.mark.parametrize("policy", ["lru", "freq", "tinylfu", "pin"])
def test_cached_zipfian_fetch_matches_reference(corpus, policy):
    """Every policy and capacity regime: the reference's bytes and the
    reference's `cache_info()` after every call."""
    a, idx, _ = corpus
    rng = np.random.default_rng(11)
    batches = [zipf_ids(rng, idx.n_reads, 48) for _ in range(4)]
    for cap in (3, 16, a.n_blocks):
        kw = {"cache_blocks": cap,
              "cache_policy": "lru" if policy == "pin" else policy}
        rs, ps = stores(corpus, **kw)
        if policy == "pin":
            for s, mod in ((rs, rcache), (ps, pcache)):
                s._cache.policy = mod.PinRangePolicy(0, 2)
                s._cache.policy.bind(s._cache)
        for b in batches:
            same_fetch(rs, ps, b)
        assert ps.cache_info()["resident"] <= cap


def test_cached_fetch_is_one_decode_per_miss_set(corpus, monkeypatch):
    a, idx, src = corpus
    _, ps = stores(corpus, cache_blocks=a.n_blocks)
    calls = []
    inner = ps.decoder.decode_blocks
    monkeypatch.setattr(ps.decoder, "decode_blocks", lambda sel, **kw: (
        calls.append(len(sel)), inner(sel, **kw))[1])
    rng = np.random.default_rng(7)
    ids = zipf_ids(rng, idx.n_reads, 64)
    ps.fetch_reads(ids)
    assert len(calls) == 1
    ps.fetch_reads(ids)
    assert len(calls) == 1
    ps.fetch_reads(zipf_ids(rng, idx.n_reads, 64))
    assert len(calls) <= 2
    assert ps.cache_info()["decode_launches"] == len(calls)


def test_failed_decode_does_not_poison_cache(corpus, monkeypatch):
    a, idx, _ = corpus
    rs, ps = stores(corpus, cache_blocks=a.n_blocks)
    ids = np.arange(0, idx.n_reads, 29)
    want = np.asarray(rs.fetch_reads(ids)[0])
    inner = ps.decoder.decode_blocks

    def boom(sel, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setattr(ps.decoder, "decode_blocks", boom)
    with pytest.raises(RuntimeError, match="device lost"):
        ps.fetch_reads(ids)
    assert ps.cache_info()["resident"] == 0
    monkeypatch.setattr(ps.decoder, "decode_blocks", inner)
    np.testing.assert_array_equal(ps.fetch_reads(ids)[0].numpy(), want)


def test_cache_info_keys_and_hit_rate(corpus):
    a, idx, _ = corpus
    rs, ps = stores(corpus)
    assert ps.cache_info() == rs.cache_info()
    rs, ps = stores(corpus, cache_blocks=a.n_blocks)
    assert set(ps.cache_info()) == set(rs.cache_info())
    rng = np.random.default_rng(3)
    for _ in range(5):
        same_fetch(rs, ps, zipf_ids(rng, idx.n_reads, 64))
    info = ps.cache_info()
    assert info["hits"] > info["misses"]


@pytest.mark.parametrize("mode2", [True, False], ids=["mode2", "mode1"])
def test_fetch_block_range_rides_plan_and_cache(corpus, mode2):
    a, idx, src = corpus
    rs, ps = stores(corpus, cache_blocks=a.n_blocks)
    for b0, b1 in ((0, a.n_blocks), (2, 5), (3, 3)):
        got = ps.fetch_block_range(b0, b1, mode2=mode2)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(rs.fetch_block_range(b0, b1,
                                                         mode2=mode2)))
        assert ps.cache_info() == rs.cache_info()
    rows = ps.fetch_block_range(0, a.n_blocks).numpy()
    for b in range(a.n_blocks):
        lo, ln = int(a.block_start[b]), int(a.block_len[b])
        np.testing.assert_array_equal(rows[b, :ln], src[lo:lo + ln])
        assert not rows[b, ln:].any()
    assert ps.cache_info()["hits"] > 0


def test_cached_miss_path_buckets():
    data = mixed_payload(BS)
    a = renc.encode(data, block_size=BS)
    rs = RStore(a, backend="ref", cache_blocks=a.n_blocks)
    ps = PStore(port_archive(a), device="cpu", cache_blocks=a.n_blocks)
    ids = np.arange(a.n_blocks)
    for s in (rs, ps):
        s.fetch_records(ids[:-1], BS)
    assert ps.cache_info() == rs.cache_info()
    assert ps.decoder.launch_rounds_last == rs.decoder.launch_rounds_last
    assert len(set(ps.decoder.launch_rounds_last)) == \
        np.unique(ps.decoder.block_rounds).size
    cp = PStore(port_archive(a), device="cpu",
                cache_blocks=a.n_blocks)._cache.plan(ids)
    assert sorted(r for r, _ in cp.miss_groups) == sorted(
        int(v) for v in np.unique(ps.decoder.block_rounds))


# ------------------------------------------- global window co-install
@pytest.fixture(scope="module")
def deep_global():
    raw = deep_chain_payload(60_000)
    return raw, renc.encode(raw.tobytes(), block_size=BS, mode="global",
                            anchor_interval=4)


@pytest.mark.parametrize("mode2", [True, False], ids=["mode2", "mode1"])
def test_cache_coinstalls_anchor_window(deep_global, mode2):
    """Block 7's miss decodes window [4, 7]: one install and three
    co-installs, then the whole window is hits — as in the reference."""
    raw, a = deep_global
    rs = RStore(a, backend="ref", cache_blocks=16)
    ps = PStore(port_archive(a), device="cpu", cache_blocks=16)
    for b0, b1 in ((7, 8), (4, 8), (9, 12)):
        got = ps.fetch_block_range(b0, b1, mode2=mode2)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(rs.fetch_block_range(b0, b1,
                                                         mode2=mode2)))
        info = ps.cache_info()
        assert info == rs.cache_info()
        if (b0, b1) == (7, 8):
            assert info["decode_launches"] == 1 and info["coinstalls"] == 3
        if (b0, b1) == (4, 8):
            assert info["decode_launches"] == 1 and info["hits"] >= 4
    assert ps.decoder.last_window_rows == []
    assert not ps.decoder.collect_window_rows


def test_coinstall_respects_capacity(deep_global):
    raw, a = deep_global
    rs = RStore(a, backend="ref", cache_blocks=2)
    ps = PStore(port_archive(a), device="cpu", cache_blocks=2)
    ps.fetch_block_range(7, 8)
    rs.fetch_block_range(7, 8)
    info = ps.cache_info()
    assert info == rs.cache_info()
    assert (info["resident"], info["coinstalls"], info["evictions"]) == \
        (2, 1, 0)
    got = np.concatenate([
        ps.fetch_block_range(b, b + 1).numpy()[0, :int(a.block_len[b])]
        for b in range(a.n_blocks)])
    assert got.tobytes() == raw.tobytes()
