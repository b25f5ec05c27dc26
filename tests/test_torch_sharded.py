"""Multi-device residency of the PyTorch port on the CPU against the JAX
reference: replicated and partitioned sharded decode, the per-shard
block cache, the sharded executor and streaming, the frontend budget,
shard-local verify, shard-loss healing and the elastic restore over a
mesh.

The reference runs once, in one module-scoped subprocess with four
forced host devices (`--xla_force_host_platform_device_count=4`, as
`tests/test_sharded.py` runs it with eight: the flag must never be set
in-process). It writes its archives, rows and counters to files under
`tmp_path`. The port runs in process on a mesh of the same shape over
four `cpu` shards, on the reference's archives (its serialized bytes),
and is held to the reference's bytes and to its counters:
`bounds`, `per_shard_bytes`, `device_bytes`, `decoded_blocks_last`,
`launch_rounds_last`, `cache_info()`, `chunk_log`, `FaultInjector.log`,
`shard_rebuilds` and the block `BlockDigestError` names. Only the
reference's jit-cache retrace count has no counterpart.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro.api import plan as rplan
from repro.core import sharded_decode as rsd
from repro_torch.api import plan as pplan
from repro_torch.api.address import ByteRange
from repro_torch.api.archive import GenomicArchive
from repro_torch.api.cache import ShardedBlockCache
from repro_torch.api.executors import ShardedExecutor, StreamingExecutor
from repro_torch.checkpoint.checkpointer import CheckpointConfig, Checkpointer
from repro_torch.core import format as pfmt
from repro_torch.core import sharded_decode as psd
from repro_torch.core.decoder import BlockDigestError, Decoder
from repro_torch.core.encoder import encode
from repro_torch.core.residency import CompressedResidentStore
from repro_torch.distributed.fault_tolerance import elastic_reshard
from repro_torch.launch.mesh import (Mesh, dp_axes, make_local_mesh,
                                     make_mesh, mesh_shards, shard_devices,
                                     shard_slices)
from repro_torch.resilience.faults import FaultInjector
from repro_torch.serving.frontend import ServingFrontend

N_SHARDS = 4
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# The reference side: every case of the mirrored tests, run once on a
# mesh of four forced host devices; results go to out_dir.
REFERENCE = r"""
import dataclasses, json, os, sys
import numpy as np
import jax
from repro.api.address import ByteRange
from repro.api.archive import GenomicArchive
from repro.api.executors import ShardedExecutor, StreamingExecutor
from repro.api.plan import QueryPlanner
from repro.checkpoint.checkpointer import Checkpointer, CheckpointConfig
from repro.compat import make_mesh
from repro.core import encoder
from repro.core.decoder import BlockDigestError, Decoder
from repro.core.format import serialize
from repro.core.residency import CompressedResidentStore
from repro.core.sharded_decode import (partition_archive,
    partitioned_decode_blocks, replicate_archive, sharded_decode_blocks)
from repro.data.fastq import make_fastq
from repro.distributed.fault_tolerance import elastic_reshard
from repro.resilience.faults import FaultInjector
from repro.serving.frontend import ServingFrontend
from jax.sharding import NamedSharding, PartitionSpec as P

out_dir = sys.argv[1]
res, arrs = {}, {}
mesh = make_mesh((4,), ("data",))
assert len(jax.devices()) == 4

def save_archive(name, a):
    with open(os.path.join(out_dir, name + ".ace"), "wb") as f:
        f.write(serialize(a))

def info(ci):
    return {k: v for k, v in ci.items()}

def rounds(dec):
    return [None if r is None else int(r) for r in dec.launch_rounds_last]

data = make_fastq("platinum", n_reads=500, seed=7)
a = encoder.encode(data, block_size=4096)
save_archive("fastq", a)

# ---- test_sharded_decode_bit_perfect (replicated)
dec = Decoder(a, backend="ref")
replicate_archive(dec, mesh)
dec.launch_rounds_last = []
out = sharded_decode_blocks(dec, np.arange(a.n_blocks), mesh)
arrs["rep_rows"] = np.asarray(out)
res["rep_rounds"] = rounds(dec)
dec.launch_rounds_last = []
sub = np.random.default_rng(5).permutation(a.n_blocks)[:7]
arrs["rep_sub_rows"] = np.asarray(sharded_decode_blocks(dec, sub, mesh,
                                                        n_rounds=2))
res["rep_sub_rounds"] = rounds(dec)

# ---- test_sharded_depth_bucketed_bit_identical (mixed-depth archive)
rng = np.random.default_rng(1)
body = rng.integers(0, 256, 1024, dtype=np.uint8)
parts = [body]
while sum(p.size for p in parts) < 80_000:
    parts += [rng.integers(0, 256, 16, dtype=np.uint8), body]
head = np.concatenate(parts)[:80_000]
tail = np.random.default_rng(3).integers(0, 256, 80_000, dtype=np.uint8)
data2 = np.concatenate([head, tail]).tobytes()
a2 = encoder.encode(data2, block_size=4096)
save_archive("mixed", a2)
s2 = CompressedResidentStore(a2, backend="ref")
d2 = s2.decoder
assert d2.multi_bucket
planner2 = QueryPlanner(s2)
shallow = np.flatnonzero(d2.block_rounds < a2.max_depth)
lo = int(shallow[0]) * 4096 + 5
res["mixed_lo"] = lo
whole = lambda: planner2.plan_spans(np.array([0]), np.array([len(data2)]))
part_plan = lambda: planner2.plan_spans(np.array([lo]), np.array([6000]))
for regime in ("partition", "replicate"):
    if regime == "replicate":
        replicate_archive(d2, mesh)
    sx = ShardedExecutor(s2, mesh, residency=regime)
    for name, mk in (("whole", whole), ("shallow", part_plan)):
        d2.launch_rounds_last = []
        d2.decoded_blocks_last = 0
        rows, lens = sx.run(mk())
        arrs[f"mixed_{regime}_{name}"] = np.asarray(rows)
        res[f"mixed_{regime}_{name}"] = [rounds(d2),
                                          int(d2.decoded_blocks_last)]
d2._block_rounds = None
for regime in ("partition", "replicate"):
    sx = ShardedExecutor(s2, mesh, residency=regime)
    d2.launch_rounds_last = []
    d2.decoded_blocks_last = 0
    rows, _ = sx.run(whole())
    arrs[f"mixed_{regime}_unbucketed"] = np.asarray(rows)
    res[f"mixed_{regime}_unbucketed"] = [rounds(d2),
                                          int(d2.decoded_blocks_last)]

# ---- test_partitioned_bit_identity_residency_bound
dec = Decoder(a, backend="ref")
part = partition_archive(dec, mesh)
res["part"] = {"bounds": part.bounds.tolist(), "nb_max": part.nb_max,
               "w_max": part.w_max,
               "per_shard_device_bytes": int(part.per_shard_device_bytes),
               "total": int(sum(np.asarray(v).nbytes
                                for v in dec.arrays.values()))}
for name, sel in (("all", np.arange(a.n_blocks)),
                  ("sub", np.random.default_rng(0).permutation(
                      a.n_blocks)[:13])):
    for pad in (True, False):
        dec.launch_rounds_last = []
        dec.decoded_blocks_last = 0
        rows = partitioned_decode_blocks(dec, part, sel, pad=pad)
        arrs[f"part_{name}_{pad}"] = np.asarray(rows)
        res[f"part_{name}_{pad}"] = [rounds(dec),
                                      int(dec.decoded_blocks_last)]

# ---- test_sharded_executor_cache_hits_on_zipfian_repeat
bs = a.block_size
zipf = np.minimum(np.random.default_rng(2).zipf(1.5, size=6),
                  a.n_blocks - 1)
res["zipf"] = zipf.tolist()
for policy in ("lru", "tinylfu"):
    s = CompressedResidentStore(a, backend="ref")
    planner = QueryPlanner(s)
    sx = ShardedExecutor(s, mesh, cache_blocks=8, cache_policy=policy)
    assert sx.residency == "partition"
    log = []
    for i in range(3):
        s.decoder.launch_rounds_last = []
        rows, _ = sx.run(planner.plan_spans(zipf * bs + 3,
                                            np.full(zipf.size, bs // 2)))
        arrs[f"zipf_{policy}_{i}"] = np.asarray(rows)
        log.append([info(sx.cache_info()), rounds(s.decoder),
                    int(s.decoder.decoded_blocks_last), int(s.cache_hits)])
    res[f"zipf_{policy}"] = log

# ---- test_sharded_streaming_per_shard_budget
s = CompressedResidentStore(a, backend="ref")
sr = s.attach_sharded(mesh)
budget = 6 * bs
addrs = [ByteRange(b * bs + 17, b * bs + 17 + 64) for b in range(a.n_blocks)]
def chunk_log(st):
    return [dataclasses.astuple(c) for c in st.chunk_log]
for name, kw, ad in (("scatter", {"sharded": sr}, addrs),
                     ("scatter_flat", {}, addrs),
                     ("range", {"sharded": sr}, [ByteRange(0, len(data))])):
    st = StreamingExecutor(s, max_resident_bytes=budget, **kw)
    arrs[f"stream_{name}"] = np.concatenate(list(st.chunks(ad)))
    res[f"stream_{name}"] = chunk_log(st)

# ---- test_frontend_budget_sums_per_shard_bytes
ga = GenomicArchive.from_bytes(data, block_size=4096, backend="ref")
sr = ga.store.attach_sharded(mesh, cache_blocks=4)
fe = ServingFrontend(ga, device_budget_bytes=sr.device_bytes())
res["frontend"] = {"fe": int(fe.device_bytes()),
                   "sr": int(sr.device_bytes()),
                   "per_shard": int(sr.per_shard_bytes())}
try:
    ServingFrontend(ga, device_budget_bytes=sr.device_bytes() - 1)
    res["frontend"]["over"] = None
except ValueError as e:
    res["frontend"]["over"] = str(e)

# ---- test_sharded_verify_names_true_block_id
bad = a.n_blocks // 2
w_start = np.asarray(a.word_off, np.int64).min(axis=1)
words = np.array(a.words)
words[int(w_start[bad])] ^= 0x5A5A
s3 = CompressedResidentStore(dataclasses.replace(a, words=words),
                             backend="ref")
sx = ShardedExecutor(s3, mesh, verify=True)
try:
    sx.run(QueryPlanner(s3).plan_spans(np.array([0]),
                                       np.array([len(data)])))
    res["verify_msg"] = None
except BlockDigestError as e:
    res["verify_msg"] = str(e)

# ---- test_resilience: test_sharded_flip_and_shard_loss_recover
rng = np.random.default_rng(3)
flat = rng.integers(0, 255, 16384, dtype=np.uint8).tobytes()
ap = encoder.encode(flat, block_size=256, parity_group=4)
save_archive("parity", ap)
st = CompressedResidentStore(ap)
sr = st.attach_sharded(mesh, verify=True, on_error="repair")
uniq = np.arange(st.decoder.da.n_blocks, dtype=np.int64)
arrs["heal_ref"] = np.asarray(sr.rows_for_blocks(uniq))
fi = FaultInjector(seed=3)
trials = []
for t in range(20):
    fi.flip_payload_word(st.decoder)
    sr.part.arrays = partition_archive(st.decoder, sr.part.mesh,
                                       sr.axes).arrays
    arrs[f"heal_flip_{t}"] = np.asarray(sr.rows_for_blocks(uniq))
    trials.append([dict(st.decoder.recover_info()), sr.shard_rebuilds,
                   rounds(st.decoder), int(st.decoder.decoded_blocks_last)])
    if st.decoder.recover_info()["reconstructed"] >= 1:
        break
res["heal_trials"] = trials
ev = fi.drop_shard(sr)
arrs["heal_drop"] = np.asarray(sr.rows_for_blocks(uniq))
res["heal_drop"] = [sr.shard_rebuilds, dict(st.decoder.recover_info()),
                    rounds(st.decoder), int(st.decoder.decoded_blocks_last)]
res["heal_log"] = fi.log

# ---- test_elastic_reshard_across_mesh_shapes
ck_dir = os.path.join(out_dir, "ckpt")
ck = Checkpointer(CheckpointConfig(directory=ck_dir))
ck.save(1, {"params": {"w": jax.numpy.arange(64 * 16, dtype=jax.numpy.float32)
                       .reshape(64, 16)}})
mesh22 = make_mesh((2, 2), ("data", "model"))
for name, m, spec in (("rows", mesh, ("data", None)),
                      ("cols", mesh, (None, "data")),
                      ("grid", mesh22, ("data", "model")),
                      ("repl", mesh22, ("data",))):
    w = elastic_reshard(ck, {"params.w": NamedSharding(m, P(*spec))}
                        )["params"]["w"]
    by_dev = {sh.device: np.asarray(sh.data) for sh in w.addressable_shards}
    for i, d in enumerate(m.devices.flat):
        arrs[f"reshard_{name}_{i}"] = by_dev[d]

np.savez(os.path.join(out_dir, "ref.npz"), **arrs)
with open(os.path.join(out_dir, "ref.json"), "w") as f:
    json.dump(res, f)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results: (json dict, npz arrays, out dir)."""
    out = tmp_path_factory.mktemp("sharded_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run = subprocess.run([sys.executable, "-c", REFERENCE, str(out)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out / "ref.json") as f:
        res = json.load(f)
    return res, dict(np.load(out / "ref.npz")), out


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def archive(ref, name):
    with open(ref[2] / f"{name}.ace", "rb") as f:
        return pfmt.deserialize(f.read())


def cpu_mesh(n=N_SHARDS) -> Mesh:
    return make_mesh((n,), ("data",), ["cpu"] * n)


def rounds(dec):
    return [None if r is None else int(r) for r in dec.launch_rounds_last]


def source(ref):
    a = archive(ref, "fastq")
    return a, Decoder(a, device="cpu").decode_all()


# ------------------------------------------------------------------ mesh
def test_mesh_construction_and_shard_devices():
    m = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    assert m == make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    assert m != cpu_mesh() and hash(m) == hash(
        make_mesh((2, 2), ("data", "model"), ["cpu"] * 4))
    assert dp_axes(m) == ("data",) and mesh_shards(m, ("data",)) == 2
    assert mesh_shards(m, ("data", "model")) == 4
    assert shard_devices(m, ("data",)) == [torch.device("cpu")] * 2
    local = make_local_mesh()          # no card, no process group
    assert local.shape == {"data": 1, "model": 1}
    assert list(local.devices.flat) == [torch.device("cpu")]
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((4,), ("data",), ["cpu"] * 3)
    with pytest.raises(ValueError, match="rank"):
        make_mesh((4,), ("data", "model"), ["cpu"] * 4)


def test_split_shards_and_shard_selection_match_reference():
    rng = np.random.default_rng(11)
    bounds = np.array([0, 5, 6, 20, 31], np.int64)
    blocks = rng.permutation(31)[:17]
    for a, b in zip(pplan.split_shards(blocks, bounds),
                    rplan.split_shards(blocks, bounds)):
        np.testing.assert_array_equal(a, b)
    shard, local = pplan.split_shards(blocks, bounds)
    for pad in (True, False):
        for a, b in zip(pplan.shard_selection(shard, local, 4, pad=pad),
                        rplan.shard_selection(shard, local, 4, pad=pad)):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------- replicated / partitioned
def test_sharded_decode_bit_perfect(ref):
    res, arrs, _ = ref
    a, src = source(ref)
    dec = Decoder(a, device="cpu")
    mesh = cpu_mesh()
    psd.replicate_archive(dec, mesh)
    out = psd.sharded_decode_blocks(dec, np.arange(a.n_blocks), mesh)
    assert out.device == dec.device
    np.testing.assert_array_equal(out.numpy(), arrs["rep_rows"])
    np.testing.assert_array_equal(out.numpy().reshape(-1)[:src.size], src)
    assert rounds(dec) == res["rep_rounds"]
    dec.launch_rounds_last = []
    sub = np.random.default_rng(5).permutation(a.n_blocks)[:7]
    np.testing.assert_array_equal(
        psd.sharded_decode_blocks(dec, sub, mesh, n_rounds=2).numpy(),
        arrs["rep_sub_rows"])
    assert rounds(dec) == res["rep_sub_rounds"]


@pytest.mark.parametrize("regime", ["partition", "replicate"])
def test_sharded_depth_bucketed_bit_identical(ref, regime):
    res, arrs, _ = ref
    a2 = archive(ref, "mixed")
    s2 = CompressedResidentStore(a2, device="cpu")
    d2 = s2.decoder
    data2 = d2.decode_all().tobytes()
    mesh = cpu_mesh()
    planner = s2._api()[0]
    lo = res["mixed_lo"]
    sx = ShardedExecutor(s2, mesh, residency=regime)
    assert sx.residency == regime
    plans = {"whole": (0, len(data2)), "shallow": (lo, 6000)}
    for name, (s, n) in plans.items():
        d2.launch_rounds_last = []
        d2.decoded_blocks_last = 0
        rows, lens = sx.run(planner.plan_spans(np.array([s]),
                                               np.array([n])))
        assert bytes(rows[0, :n].numpy()) == data2[s:s + n]
        assert int(lens[0]) == n
        np.testing.assert_array_equal(rows.numpy(),
                                      arrs[f"mixed_{regime}_{name}"])
        assert [rounds(d2), d2.decoded_blocks_last] == \
            res[f"mixed_{regime}_{name}"]
    assert max(res[f"mixed_{regime}_shallow"][0]) < a2.max_depth
    d2._block_rounds = None
    d2.launch_rounds_last = []
    d2.decoded_blocks_last = 0
    rows, _ = sx.run(planner.plan_spans(np.array([0]),
                                        np.array([len(data2)])))
    np.testing.assert_array_equal(rows.numpy(),
                                  arrs[f"mixed_{regime}_unbucketed"])
    assert [rounds(d2), d2.decoded_blocks_last] == \
        res[f"mixed_{regime}_unbucketed"]
    assert rounds(d2) == [a2.max_depth]


def test_partitioned_bit_identity_and_residency_bound(ref):
    res, arrs, _ = ref
    a, src = source(ref)
    dec = Decoder(a, device="cpu")
    part = psd.partition_archive(dec, cpu_mesh())
    want = res["part"]
    assert part.bounds.tolist() == want["bounds"]
    assert (part.nb_max, part.w_max) == (want["nb_max"], want["w_max"])
    assert part.per_shard_device_bytes == want["per_shard_device_bytes"]
    # every shard pads to one geometry: its tensors are the reference's
    # slice of each stacked array
    assert {sh.device_bytes for sh in part.shards} == {
        part.per_shard_device_bytes}
    # residency bound: total/n_shards + one shard's slack (the widest
    # block's words + the padded table rows every shard carries)
    w_start = np.asarray(a.word_off, np.int64).min(axis=1)
    w_end = np.concatenate([w_start[1:], [np.int64(a.words.size)]])
    slack = int((w_end - w_start).max()) * 2 + part.nb_max * 64
    assert part.per_shard_device_bytes <= want["total"] // N_SHARDS + slack
    for name, sel in (("all", np.arange(a.n_blocks)),
                      ("sub", np.random.default_rng(0).permutation(
                          a.n_blocks)[:13])):
        for pad in (True, False):
            dec.launch_rounds_last = []
            dec.decoded_blocks_last = 0
            rows = psd.partitioned_decode_blocks(dec, part, sel, pad=pad)
            np.testing.assert_array_equal(rows.numpy(),
                                          arrs[f"part_{name}_{pad}"])
            assert [rounds(dec), dec.decoded_blocks_last] == \
                res[f"part_{name}_{pad}"]
    np.testing.assert_array_equal(
        arrs["part_all_True"].reshape(-1)[:src.size], src)
    # the shards hold their own copies: the host archive is untouched by
    # a write to a shard's words
    part.shards[0].words.zero_()
    assert a.words.any()


def test_partition_rejects_what_the_reference_rejects():
    data = bytes(range(256)) * 64
    g = Decoder(encode(data, block_size=1024, mode="global",
                       anchor_interval=4), device="cpu")
    with pytest.raises(NotImplementedError, match='"ra" archives only'):
        psd.partition_archive(g, cpu_mesh())
    with pytest.raises(NotImplementedError, match='"ra" archives only'):
        psd.sharded_decode_blocks(g, [0], cpu_mesh())
    small = Decoder(encode(data[:2048], block_size=1024), device="cpu")
    with pytest.raises(ValueError, match="cannot partition over 4"):
        psd.partition_archive(small, cpu_mesh())
    # a shard past 2^31 words: both packages reject it before any copy
    # (a zero-stride word buffer of 2^32 words takes no memory)
    a = dataclasses.replace(
        small.archive, words=np.broadcast_to(np.zeros(1, np.uint16),
                                             (2**32,)))
    fake = dataclasses.make_dataclass("D", ["archive", "da"])
    for mod, mesh in ((psd, cpu_mesh(1)),
                      (rsd, rsd.Mesh(np.array(jax.devices()[:1]),
                                     ("data",)))):
        with pytest.raises(ValueError, match="2\\^31"):
            mod.partition_archive(fake(a, small.da), mesh)


# ------------------------------------------------------------ the cache
@pytest.mark.parametrize("policy", ["lru", "tinylfu"])
def test_sharded_executor_cache_hits_on_zipfian_repeat(ref, policy):
    res, arrs, _ = ref
    a, src = source(ref)
    bs = a.block_size
    s = CompressedResidentStore(a, device="cpu")
    planner = s._api()[0]
    sx = ShardedExecutor(s, cpu_mesh(), cache_blocks=8, cache_policy=policy)
    assert sx.residency == "partition"
    zipf = np.asarray(res["zipf"])
    for i, want in enumerate(res[f"zipf_{policy}"]):
        s.decoder.launch_rounds_last = []
        rows, _ = sx.run(planner.plan_spans(zipf * bs + 3,
                                            np.full(zipf.size, bs // 2)))
        np.testing.assert_array_equal(rows.numpy(),
                                      arrs[f"zipf_{policy}_{i}"])
        for b, row in zip(zipf, rows.numpy()):
            lo = int(b) * bs + 3
            assert bytes(row[:bs // 2]) == src[lo:lo + bs // 2].tobytes()
        got = [sx.cache_info(), rounds(s.decoder),
               s.decoder.decoded_blocks_last, s.cache_hits]
        assert got == want
    ci = sx.cache_info()
    assert ci["hits"] > 0 and ci["misses"] > 0
    assert len(ci["per_shard"]) == N_SHARDS
    assert s.cache_info() == ci          # the store falls through


def test_sharded_cache_holds_one_slot_tensor_per_shard(ref):
    a, _ = source(ref)
    s = CompressedResidentStore(a, device="cpu")
    sr = s.attach_sharded(cpu_mesh(), cache_blocks=4)
    c = sr._cache
    assert len(c.bufs) == N_SHARDS
    assert all(b.shape == (4, a.block_size) for b in c.bufs)
    assert c.per_shard_buffer_bytes == 4 * a.block_size
    assert c.buffer_bytes == N_SHARDS * c.per_shard_buffer_bytes
    assert all(p.buf is None for p in c.shards)   # planning-only caches
    with pytest.raises(RuntimeError, match="planning-only"):
        c.shards[0].realize(c.shards[0].plan(np.array([0])), None)
    with pytest.raises(TypeError, match="PER shard"):
        from repro_torch.api.cache import LRUPolicy
        ShardedBlockCache(4, a.block_size, a.n_blocks, sr.part,
                          policy=LRUPolicy())
    # idempotent attach for a matching geometry; another geometry rebuilds
    assert s.attach_sharded(cpu_mesh(), cache_blocks=4) is sr
    assert s.attach_sharded(cpu_mesh(), cache_blocks=2) is not sr


def test_sharded_executor_rejects_bad_regimes(ref):
    a, _ = source(ref)
    s = CompressedResidentStore(a, device="cpu")
    with pytest.raises(ValueError, match="residency="):
        ShardedExecutor(s, cpu_mesh(), residency="mirror")
    with pytest.raises(ValueError, match="partitioned regime"):
        ShardedExecutor(s, cpu_mesh(), residency="replicate",
                        cache_blocks=4)
    sx = ShardedExecutor(s, cpu_mesh(), residency="replicate")
    assert sx.cache_info()["policy"] == "off"
    rows, lens = sx.run(s._api()[0].plan_spans(np.zeros(0, np.int64),
                                               np.zeros(0, np.int64)))
    assert rows.shape[0] == 0 and lens.shape == (0,)


# ------------------------------------------------------------ streaming
@pytest.mark.parametrize("name", ["scatter", "scatter_flat", "range"])
def test_sharded_streaming_per_shard_budget(ref, name):
    res, arrs, _ = ref
    a, src = source(ref)
    bs = a.block_size
    s = CompressedResidentStore(a, device="cpu")
    sr = s.attach_sharded(cpu_mesh())
    budget = 6 * bs
    if name == "range":
        addrs = [ByteRange(0, int(src.size))]
        want = src
    else:
        addrs = [ByteRange(b * bs + 17, b * bs + 17 + 64)
                 for b in range(a.n_blocks)]
        want = np.concatenate([src[b * bs + 17:b * bs + 81]
                               for b in range(a.n_blocks)])
    kw = {} if name == "scatter_flat" else {"sharded": sr}
    st = StreamingExecutor(s, max_resident_bytes=budget, **kw)
    out = np.concatenate(list(st.chunks(addrs)))
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, arrs[f"stream_{name}"])
    assert [list(dataclasses.astuple(c)) for c in st.chunk_log] == \
        res[f"stream_{name}"]
    assert all(c.resident_bytes <= budget for c in st.chunk_log)
    if name == "scatter_flat":
        # the per-shard budget needs fewer chunks for the same addresses
        assert len(st.chunk_log) > len(res["stream_scatter"])


def test_sharded_streaming_rejects_global_and_mode1(ref):
    a, _ = source(ref)
    s = CompressedResidentStore(a, device="cpu")
    sr = s.attach_sharded(cpu_mesh())
    with pytest.raises(ValueError, match="mode-2 only"):
        StreamingExecutor(s, max_resident_bytes=8 * a.block_size,
                          sharded=sr, mode2=False)
    g = CompressedResidentStore(encode(bytes(range(256)) * 64,
                                       block_size=1024, mode="global",
                                       anchor_interval=4), device="cpu")
    with pytest.raises(ValueError, match="partitioned archive"):
        StreamingExecutor(g, max_resident_bytes=64 * 1024, sharded=sr)


# ------------------------------------------------------- serving budget
def test_frontend_budget_sums_per_shard_bytes(ref):
    res, _, _ = ref
    a, src = source(ref)
    ga = GenomicArchive.from_bytes(src.tobytes(), block_size=4096,
                                   device="cpu")
    assert pfmt.serialize(ga.store.decoder.archive) == pfmt.serialize(a)
    sr = ga.store.attach_sharded(cpu_mesh(), cache_blocks=4)
    fe = ServingFrontend(ga, device_budget_bytes=sr.device_bytes())
    want = res["frontend"]
    assert fe.device_bytes() == sr.device_bytes() == want["fe"] == want["sr"]
    assert sr.device_bytes() == N_SHARDS * sr.per_shard_bytes()
    assert sr.per_shard_bytes() == want["per_shard"] == (
        sr.part.per_shard_device_bytes + 4 * a.block_size)
    with pytest.raises(ValueError, match="budget") as e:
        ServingFrontend(ga, device_budget_bytes=sr.device_bytes() - 1)
    assert str(e.value) == want["over"]


# ---------------------------------------------------- verify and healing
def test_sharded_verify_names_true_block_id(ref):
    res, _, _ = ref
    a, src = source(ref)
    bad = a.n_blocks // 2
    w_start = np.asarray(a.word_off, np.int64).min(axis=1)
    words = np.array(a.words)
    words[int(w_start[bad])] ^= 0x5A5A
    s = CompressedResidentStore(dataclasses.replace(a, words=words),
                                device="cpu")
    sx = ShardedExecutor(s, cpu_mesh(), verify=True)
    assert sx.residency == "partition"
    with pytest.raises(BlockDigestError) as e:
        sx.run(s._api()[0].plan_spans(np.array([0]),
                                      np.array([src.size])))
    assert f"block {bad} " in str(e.value)
    assert str(e.value) == res["verify_msg"]


def test_sharded_flip_and_shard_loss_recover(ref):
    res, arrs, _ = ref
    st = CompressedResidentStore(archive(ref, "parity"), device="cpu")
    sr = st.attach_sharded(cpu_mesh(), verify=True, on_error="repair")
    uniq = np.arange(st.decoder.da.n_blocks, dtype=np.int64)
    np.testing.assert_array_equal(sr.rows_for_blocks(uniq).numpy(),
                                  arrs["heal_ref"])
    fi = FaultInjector(seed=3)
    for t, want in enumerate(res["heal_trials"]):
        fi.flip_payload_word(st.decoder)
        sr.part.reseed(st.decoder.archive)
        out = sr.rows_for_blocks(uniq).numpy()
        np.testing.assert_array_equal(out, arrs["heal_flip_{}".format(t)])
        np.testing.assert_array_equal(out, arrs["heal_ref"])
        assert [st.decoder.recover_info(), sr.shard_rebuilds,
                rounds(st.decoder), st.decoder.decoded_blocks_last] == want
    assert st.decoder.recover_info()["reconstructed"] >= 1
    ev = fi.drop_shard(sr)
    assert not sr.part.shards[ev["shard"]].words.any()
    out = sr.rows_for_blocks(uniq).numpy()
    np.testing.assert_array_equal(out, arrs["heal_ref"])
    assert [sr.shard_rebuilds, st.decoder.recover_info(),
            rounds(st.decoder), st.decoder.decoded_blocks_last] == \
        res["heal_drop"]
    assert sr.shard_rebuilds >= 2
    assert fi.log == res["heal_log"]


# -------------------------------------------------------- elastic restore
@pytest.mark.parametrize("name,shape,spec", [
    ("rows", (4,), ("data", None)), ("cols", (4,), (None, "data")),
    ("grid", (2, 2), ("data", "model")), ("repl", (2, 2), ("data",))])
def test_elastic_reshard_across_mesh_shapes(ref, name, shape, spec):
    """The port restores the reference's checkpoint re-sharded: each mesh
    device's slice equals the reference's addressable shard there."""
    _, arrs, out = ref
    axes = ("data",) if len(shape) == 1 else ("data", "model")
    mesh = make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))
    ck = Checkpointer(CheckpointConfig(directory=str(out / "ckpt")))
    st = elastic_reshard(ck, {"params.w": (mesh, spec)}, device="cpu")
    w = st["params"]["w"]
    assert isinstance(w, list) and len(w) == mesh.size
    for i, piece in enumerate(w):
        np.testing.assert_array_equal(piece.numpy(),
                                      arrs[f"reshard_{name}_{i}"])
    # slices cover the array; a path with no entry restores whole
    whole = elastic_reshard(ck, {}, device="cpu")["params"]["w"]
    assert tuple(whole.shape) == (64, 16)
    assert len(shard_slices(mesh, spec, (64, 16))) == mesh.size
