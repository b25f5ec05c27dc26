"""The PyTorch port's CUDA kernels on an NVIDIA card, against their plain
PyTorch versions, byte for byte. These tests need a card and nvcc (a
CUDA kernel has no CPU mode) and skip without one; they import no JAX,
so they run on a machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import decoder as dec
from repro_torch.core.encoder import encode
from repro_torch.data.fastq import make_fastq
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

# Malformed command planes of one block, as stored (plane b of command j at
# column b * n_cmds + j): what the match kernel must decode without a
# fault, to the plain version's bytes.
MALFORMED = {
    # bytes 4..23 copy from 40 (a forward match, distance clamped to 1),
    # bytes 24..63 from 4 + (k mod 20): 20 -> 40 -> 20 is a pointer cycle
    "cycle": dict(out=64, blen=64, nc=3, C=3, ob=2,
                  commands=[4, 0, 0, 0, 0, 0], lengths=[0, 20, 40, 0, 0, 0],
                  offsets=[0, 40, 4, 0, 0, 0]),
    # the commands end at byte 15 of a 40-byte block: the tail takes the
    # empty command slot after them
    "tail": dict(out=64, blen=40, nc=2, C=3, ob=2,
                 commands=[5, 0, 0, 0, 0, 0], lengths=[0, 10, 0, 0, 0, 0],
                 offsets=[0, 0, 0, 0, 0, 0]),
    # n_cmds past the command slots: high planes clamp into the row and
    # the last slot's match runs on to the end of the block
    "overfull": dict(out=64, blen=64, nc=5, C=3, ob=2,
                     commands=[3, 2, 1, 0, 0, 0], lengths=[0, 4, 30, 0, 0, 0],
                     offsets=[0, 1, 2, 0, 0, 0]),
    # a 4-plane offset with every bit set: bit 31 masked, the source lies
    # far past the block
    "wide_offset": dict(out=32, blen=28, nc=2, C=2, ob=4,
                        commands=[8, 0, 0, 0], lengths=[0, 20, 0, 0],
                        offsets=[0, 255, 0, 255, 0, 255, 0, 255]),
}


def malformed_planes(case: str, device) -> dict:
    """Arguments of `ops.lz77_decode_planes` for one MALFORMED case."""
    c = MALFORMED[case]

    def row(v, dtype=torch.uint8):
        return torch.tensor([v], dtype=dtype, device=device)

    return dict(literals=torch.arange(1, c["out"] + 1, dtype=torch.uint8,
                                      device=device)[None],
                lengths=row(c["lengths"]), offsets=row(c["offsets"]),
                commands=row(c["commands"]),
                n_cmds=row(c["nc"], torch.int32),
                block_len=row(c["blen"], torch.int32),
                out_size=c["out"], max_cmds=c["C"], offset_bytes=c["ob"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("block", [512, 1000, 2048, 3001, 16384, 32768,
                                   65536])
def test_kernels_equal_plain_versions(cuda_device, block):
    """rANS CTA sizes 1/4/8/16; match rounds max_depth / None / one short;
    16-bit pointers up to 32 KiB, i32 pointers and 4 offset planes at
    64 KiB; 1000 and 3001 B rows take the match kernel's per-element rounds
    and per-byte stores."""
    data = make_fastq("noisy", n_reads=300, seed=block)
    a = encode(data, block_size=block)
    assert a.offset_bytes == (4 if block > 0xFFFF else 2)
    da = dec.to_device(a, cuda_device)
    sel = torch.arange(a.n_blocks, device=cuda_device)
    rin = dec._rans_inputs(da, sel)
    want = ref.rans_decode_streams_ref(**rin)
    for group in (1, 4, 8, 16):
        launches = ops.LAUNCHES["rans_decode"]
        rows = ops.rans_decode_streams(**rin, group=group)
        assert ops.LAUNCHES["rans_decode"] == launches + 1
        assert torch.equal(rows, want)
    m = dec._match_inputs(da, da.layout.split(want), sel)
    for n_rounds in (a.max_depth, None, max(a.max_depth - 1, 0)):
        got = ops.lz77_decode_planes(**m, n_rounds=n_rounds)
        assert torch.equal(got, ref.lz77_decode_planes_ref(
            **m, n_rounds=n_rounds))
    src = np.frombuffer(data, np.uint8)
    flat = ops.lz77_decode_planes(**m, n_rounds=a.max_depth).cpu().numpy()
    np.testing.assert_array_equal(flat.reshape(-1)[:src.size], src)


def test_raw_entropy_archive(cuda_device):
    data = make_fastq("platinum", n_reads=200, seed=3)
    a = encode(data, block_size=2048, entropy="raw")
    da = dec.to_device(a, cuda_device)
    sel = torch.arange(a.n_blocks, device=cuda_device)
    m = dec._match_inputs(da, dec._entropy_decode_sel(da, sel), sel)
    for n_rounds in (a.max_depth, None, max(a.max_depth - 1, 0)):
        assert torch.equal(ops.lz77_decode_planes(**m, n_rounds=n_rounds),
                           ref.lz77_decode_planes_ref(**m, n_rounds=n_rounds))
    rows = dec.Decoder(a, device=cuda_device).decode_blocks(
        np.arange(a.n_blocks))
    assert rows.cpu().numpy().reshape(-1)[:len(data)].tobytes() == data


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_planes_decode_without_fault(cuda_device, case):
    args = malformed_planes(case, cuda_device)
    for n_rounds in (None, 0, 3):
        got = ops.lz77_decode_planes(**args, n_rounds=n_rounds)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.lz77_decode_planes_ref(
            **args, n_rounds=n_rounds))


def test_mode2_decode_launches_once_per_bucket(cuda_device):
    data = make_fastq("platinum", n_reads=200, seed=4)
    d = dec.Decoder(encode(data, block_size=2048), device=cuda_device)
    before = dict(ops.LAUNCHES)
    rows = d.decode_blocks(np.arange(8), verify=True)
    buckets = len(d.launch_rounds_last)
    assert buckets >= 1
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == {
        "rans_decode": buckets, "lz77_match": buckets}
    assert rows.cpu().numpy().reshape(-1).tobytes() == data[:8 * 2048]


def test_decoder_and_store_on_the_card(cuda_device):
    from repro_torch.core.index import ReadIndex
    from repro_torch.core.residency import CompressedResidentStore
    data = make_fastq("platinum", n_reads=400, seed=9)
    idx = ReadIndex.build(data, 2048)
    s = CompressedResidentStore(encode(data, block_size=2048), idx,
                                device=cuda_device)
    assert s.decoder.decode_all(chunk_blocks=4, verify=True).tobytes() == data
    ids = np.array([0, 17, 399, 17])
    out, lens = s.fetch_reads(ids)
    assert out.is_cuda
    for i, r in enumerate(ids):
        lo, hi, _ = idx.lookup(int(r))
        assert bytes(out[i, :int(lens[i])].cpu().numpy()) == data[lo:hi]


# --------------------------------------------------- the query-plane slice
def _same_decoders(gpu, cpu, fn, *args):
    g = getattr(gpu, fn)(*args)
    c = getattr(cpu, fn)(*args)
    assert g.is_cuda and torch.equal(g.cpu(), c)
    assert gpu.decoded_blocks_last == cpu.decoded_blocks_last
    assert gpu.launch_rounds_last == cpu.launch_rounds_last
    return g


def test_global_window_decode_on_the_card(cuda_device):
    """Anchored global windows on the card equal the port on the CPU: the
    rANS kernel once per window (8 offset planes), the resolve in plain
    PyTorch, no match-kernel launch; Mode 1 uploads host streams."""
    data = make_fastq("platinum", n_reads=300, seed=6)
    a = encode(data, block_size=2048, mode="global", anchor_interval=4)
    assert a.offset_bytes == 8
    gpu = dec.Decoder(a, device=cuda_device)
    cpu = dec.Decoder(a, device="cpu")
    sel = np.array([a.n_blocks - 1, 2, 7, 2])
    before = dict(ops.LAUNCHES)
    _same_decoders(gpu, cpu, "decode_blocks", sel)
    windows = len(gpu.launch_rounds_last)
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == {
        "rans_decode": windows, "lz77_match": 0}
    before = dict(ops.LAUNCHES)
    _same_decoders(gpu, cpu, "decode_blocks_host_entropy", sel)
    assert ops.LAUNCHES == before
    rows = _same_decoders(gpu, cpu, "decode_from_anchor", 5, 9)
    assert rows.cpu().numpy().reshape(-1).tobytes() == \
        data[5 * 2048:10 * 2048]
    assert gpu.decode_all(chunk_blocks=7).tobytes() == data


@pytest.mark.parametrize("interval", [4, 0])
def test_global_origin_wraparound_on_the_card(cuda_device, interval):
    """An archive placed across 2^32: the window rebase wraps modulo 2^32
    in int64 on the card exactly as on the CPU."""
    data = make_fastq("noisy", n_reads=200, seed=7)
    a = encode(data, block_size=2048, mode="global",
               anchor_interval=interval, origin=2**32 - 2**13 + 17)
    gpu = dec.Decoder(a, device=cuda_device)
    cpu = dec.Decoder(a, device="cpu")
    rows = _same_decoders(gpu, cpu, "decode_blocks", np.arange(a.n_blocks))
    assert rows.cpu().numpy().reshape(-1)[:len(data)].tobytes() == data
    _same_decoders(gpu, cpu, "decode_blocks", np.array([a.n_blocks - 1, 1]))


def test_mode1_ra_on_the_card(cuda_device):
    """"ra" Mode 1: host-decoded stream rows uploaded as separate tensors
    into the match kernel, once per depth bucket, never the rANS kernel."""
    from repro_torch.core.index import ReadIndex
    from repro_torch.core.residency import CompressedResidentStore
    data = make_fastq("platinum", n_reads=300, seed=8)
    a = encode(data, block_size=2048)
    gpu = dec.Decoder(a, device=cuda_device)
    cpu = dec.Decoder(a, device="cpu")
    before = dict(ops.LAUNCHES)
    rows = _same_decoders(gpu, cpu, "decode_blocks_host_entropy",
                          np.arange(a.n_blocks))
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == {
        "rans_decode": 0, "lz77_match": len(gpu.launch_rounds_last)}
    assert rows.cpu().numpy().reshape(-1)[:len(data)].tobytes() == data
    idx = ReadIndex.build(data, 2048)
    ids = np.array([0, 5, 299, 5])
    g = CompressedResidentStore(a, idx, device=cuda_device).fetch_reads(
        ids, mode2=False)
    c = CompressedResidentStore(a, idx, device="cpu").fetch_reads(
        ids, mode2=False)
    for x, y in zip(g, c):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("mode,policy", [("ra", "lru"), ("ra", "tinylfu"),
                                         ("global", "lru")])
def test_cached_fetch_on_the_card(cuda_device, mode, policy):
    """The block cache's buffer on the card: the same bytes and the same
    `cache_info()` as the port on the CPU after every call."""
    from repro_torch.core.index import ReadIndex
    from repro_torch.core.residency import CompressedResidentStore
    data = make_fastq("platinum", n_reads=400, seed=9)
    a = encode(data, block_size=2048, mode=mode,
               anchor_interval=4 if mode == "global" else 0)
    idx = ReadIndex.build(data, 2048)
    gpu, cpu = (CompressedResidentStore(a, idx, device=d, cache_blocks=8,
                                        cache_policy=policy)
                for d in (cuda_device, "cpu"))
    assert gpu._cache.buf.is_cuda
    rng = np.random.default_rng(4)
    p = 1.0 / np.arange(1, idx.n_reads + 1) ** 1.1
    for _ in range(6):
        ids = rng.choice(idx.n_reads, size=32, p=p / p.sum())
        for x, y in zip(gpu.fetch_reads(ids), cpu.fetch_reads(ids)):
            assert torch.equal(x.cpu(), y)
        assert gpu.cache_info() == cpu.cache_info()
    assert gpu.cache_info()["hits"] > 0


def test_streaming_peak_memory_on_the_card(cuda_device):
    """A stream four times longer under the same budget peaks within 10 %
    of the shorter one: output size does not set device memory."""
    from repro_torch.api.address import ByteRange
    from repro_torch.api.executors import StreamingExecutor
    from repro_torch.core.residency import CompressedResidentStore
    data = make_fastq("platinum", n_reads=4000, seed=10)
    a = encode(data, block_size=4096)
    store = CompressedResidentStore(a, device=cuda_device)
    cpu = CompressedResidentStore(a, device="cpu")
    budget = 16 * 4096
    peaks = []
    for hi in (len(data) // 4, len(data)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ex = StreamingExecutor(store, max_resident_bytes=budget)
        out = np.concatenate(list(ex.chunks([ByteRange(0, hi)])))
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        assert out.tobytes() == data[:hi]
        ref_ex = StreamingExecutor(cpu, max_resident_bytes=budget)
        list(ref_ex.chunks([ByteRange(0, hi)]))
        assert ex.chunk_log == ref_ex.chunk_log
        assert all(c.resident_bytes <= budget for c in ex.chunk_log)
    assert peaks[1] <= 1.1 * peaks[0], peaks


# ------------------------------------------- the self-healing and serving
def _parity_pair(cuda_device, **kw):
    """(card, CPU) decoders over two copies of one parity-4 archive."""
    from repro_torch.core import format as fmt
    data = make_fastq("platinum", n_reads=300, seed=21)
    a = encode(data, block_size=2048, parity_group=4, **kw)
    return (data, dec.Decoder(a, device=cuda_device),
            dec.Decoder(fmt.deserialize(fmt.serialize(a)), device="cpu"))


def test_xor_rebuild_on_the_card(cuda_device):
    """The parity rebuild on the card patches the resident words to the
    CPU rebuild's words, and both to the words before the flip."""
    from repro_torch.resilience.faults import FaultInjector
    _, gpu, cpu = _parity_pair(cuda_device)
    clean = gpu.archive.words.copy()
    blocks = []
    for d in (gpu, cpu):
        fi = FaultInjector(seed=3)
        blocks = [fi.flip_payload_word(d)["block"] for _ in range(3)]
    assert not np.array_equal(gpu.archive.words, clean)
    for d in (gpu, cpu):
        np.testing.assert_array_equal(d.heal_blocks(blocks), sorted(blocks))
    torch.cuda.synchronize()
    assert torch.equal(gpu.da.words.cpu(), cpu.da.words)
    np.testing.assert_array_equal(gpu.archive.words, clean)
    np.testing.assert_array_equal(
        gpu.da.words.cpu().numpy().view(np.uint16), clean)


@pytest.mark.parametrize("mode,on_error", [("ra", "repair"),
                                           ("global", "repair"),
                                           ("ra", "partial")])
def test_repair_and_partial_decode_on_the_card(cuda_device, mode, on_error):
    """A repaired or partial decode on the card: through both kernels,
    the same bytes, `recover_info()`, quarantine and counters as on the
    CPU; repaired output is the source."""
    from repro_torch.core.format import block_payload_bounds
    from repro_torch.resilience.faults import FaultInjector
    data, gpu, cpu = _parity_pair(
        cuda_device, mode=mode, anchor_interval=4 if mode == "global" else 0)
    starts, ends = block_payload_bounds(gpu.archive)
    blocks = [b for b in range(4, 8) if ends[b] > starts[b]][:2]
    for d in (gpu, cpu):
        fi = FaultInjector(seed=5)
        for b in (blocks if on_error == "partial" else blocks[:1]):
            fi.flip_payload_word(d, block=b)
    before = dict(ops.LAUNCHES)
    got = gpu.decode_all(chunk_blocks=16, verify=True, on_error=on_error)
    assert ops.LAUNCHES["rans_decode"] > before["rans_decode"]
    if mode == "ra":
        assert ops.LAUNCHES["lz77_match"] > before["lz77_match"]
    want = cpu.decode_all(chunk_blocks=16, verify=True, on_error=on_error)
    np.testing.assert_array_equal(got, want)
    assert gpu.recover_info() == cpu.recover_info()
    assert gpu.quarantined == cpu.quarantined
    assert gpu.decoded_blocks_last == cpu.decoded_blocks_last
    assert gpu.launch_rounds_last == cpu.launch_rounds_last
    if on_error == "repair":
        assert got.tobytes() == data
        assert gpu.recover_info()["reconstructed"] >= 1
    else:
        assert gpu.recover_info()["quarantined"] >= 1
        with pytest.raises(dec.BlockDigestError, match="quarantined"):
            gpu.decode_blocks(blocks, verify=True, on_error="repair")


def test_serving_frontend_on_the_card(cuda_device):
    """A small ServingFrontend cycle over an archive on the card: read
    ids, byte ranges and a named region, two tenants on a partitioned
    cache — the same payloads and counters as on the CPU, through both
    kernels."""
    from repro_torch.api.archive import GenomicArchive
    from repro_torch.serving.admission import TenantPartitionPolicy
    from repro_torch.serving.frontend import ServingFrontend
    data = make_fastq("platinum", n_reads=400, seed=22)
    addrs = [3, 17, 17, 399, slice(100, 5000), "SRR0.12:2-40", 250]
    outs = []
    for device in (cuda_device, "cpu"):
        ga = GenomicArchive.from_bytes(
            data, block_size=2048, device=device, cache_blocks=16,
            cache_policy=TenantPartitionPolicy({"a": 4, "b": 4}))
        fe = ServingFrontend({"w": ga}, max_batch=4)
        fe.register_tenant("a", "w", priority=0)
        fe.register_tenant("b", "w", priority=1)
        before = dict(ops.LAUNCHES)
        tickets = [fe.submit("ab"[i % 2], x) for i, x in enumerate(addrs)]
        fe.drain()
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
        res = [fe.result(t) for t in tickets]
        assert all(r.ok for r in res)
        st = fe.stats()
        outs.append(([bytes(r.payload) for r in res], st["tenants"],
                     st["steps"], ga.cache_info()))
        if device != "cpu":
            assert all(launched.values()), launched
    assert outs[0] == outs[1]
    src = data
    assert outs[0][0][0] == bytes(GenomicArchive.from_bytes(
        src, block_size=2048, device="cpu")[3])
    assert outs[0][0][4] == src[100:5000]
