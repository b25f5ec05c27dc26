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


# ------------------------------------------------------ training slice
def _reduced_lm():
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    return build_model(get_config("qwen2-1.5b").reduced())


def _rel(want: torch.Tensor, got: torch.Tensor) -> float:
    want = want.double()
    return float((got.double() - want).norm() / want.norm())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_on_the_card_matches_the_cpu(cuda_device, dtype):
    """One reduced-config step from the same weights and batch: loss and
    gradient norm within the tolerance of the CPU's, and the new params
    held by relative norm (worst readings on an H100 in brackets; the
    test prints them under `pytest -s`): fp32, each leaf's update
    (new minus initial params) within 1e-2 [1.8e-3] and its params
    within 1e-4 [3.1e-6]; bf16, the bounds of `test_torch_training.py`:
    each leaf's params within 2^-5 [3.1e-3] and the update of all
    leaves within 0.15 [9.0e-2]. A leaf that never moved reads 1."""
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step
    assert not torch.backends.cuda.matmul.allow_tf32
    model = _reduced_lm()
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = model.init(torch.Generator().manual_seed(4),
                        getattr(torch, dtype))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (4, 65)).astype(np.int32))
    out = {}
    for dev in ("cpu", cuda_device):
        p = {k: v.to(dev, copy=True) for k, v in params.items()}  # donated
        st = {"params": p, "opt": init_opt_state(p)}
        b = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        st, m = make_train_step(model, opt, remat="none")(st, b)
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]),
                         {k: v.float().cpu() for k, v in st["params"].items()})
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out[str(cuda_device)]
    p0 = {k: v.float() for k, v in params.items()}
    prel = {k: _rel(pc[k], pg[k]) for k in pc}
    urel = {k: _rel(pc[k] - p0[k], pg[k] - p0[k]) for k in pc}
    whole = _rel(torch.cat([(pc[k] - p0[k]).ravel() for k in pc]),
                 torch.cat([(pg[k] - p0[k]).ravel() for k in pc]))
    print(f"card vs cpu {dtype}: loss {abs(lg - lc) / abs(lc):.3e} "
          f"grad_norm {abs(gg - gc) / abs(gc):.3e} "
          f"params {max(prel.values()):.3e} ({max(prel, key=prel.get)}) "
          f"update {max(urel.values()):.3e} ({max(urel, key=urel.get)}) "
          f"whole update {whole:.3e}")
    tol_loss = 1e-4 if dtype == "float32" else 2e-2
    assert abs(lg - lc) <= tol_loss * abs(lc), (lg, lc)
    assert abs(gg - gc) <= 5e-2 * abs(gc), (gg, gc)
    for k in pc:
        if dtype == "float32":
            assert urel[k] <= 1e-2 and prel[k] <= 1e-4, (k, urel[k], prel[k])
        else:
            assert prel[k] <= 2 ** -5, (k, prel[k])
    assert dtype == "float32" or whole <= 0.15, whole


def test_dataset_batches_on_the_card_are_the_source_bytes(cuda_device):
    """Prefetched batches decoded on the worker's CUDA stream: int32
    tensors on the card, equal to the source bytes (cut or zero-padded)
    and to the CPU's batches; both kernels launched."""
    from repro_torch.api.archive import GenomicArchive
    data = make_fastq("platinum", n_reads=600, seed=31)
    seq = 300
    ga = GenomicArchive.from_bytes(data, block_size=4096, device=cuda_device)
    cpu = GenomicArchive.from_bytes(data, block_size=4096, device="cpu")
    starts = ga.store.index.starts.astype(np.int64)
    before = dict(ops.LAUNCHES)
    ds = ga.dataset(batch_size=8, seq_len=seq, prefetch=2, seed=5)
    ref_ds = cpu.dataset(batch_size=8, seq_len=seq, prefetch=0, seed=5)
    it = iter(ds)
    for step in range(6):
        b = next(it)
        assert b["tokens"].device.type == "cuda"
        assert b["tokens"].dtype == torch.int32
        want = ref_ds.batch_at(step)
        assert torch.equal(b["tokens"].cpu(), want["tokens"])
        assert torch.equal(b["labels"].cpu(), want["labels"])
        rows = torch.cat([b["tokens"][:, :1], b["labels"]], 1).cpu().numpy()
        for row, r in zip(rows, ds.sampler.sample(step)):
            src = np.frombuffer(data[starts[r]:starts[r + 1]], np.uint8)
            src = src[:seq + 1]
            assert (row[:src.size] == src).all() and not row[src.size:].any()
    ds.close()
    assert all(ops.LAUNCHES[k] > before[k] for k in before)


def test_checkpoint_restore_on_the_card(cuda_device, tmp_path):
    """A compressed checkpoint restores by decoding on the card (both
    kernels), bit-equal to what was saved, bf16 and int32 included."""
    from repro_torch.checkpoint.checkpointer import (CheckpointConfig,
                                                     Checkpointer)
    from repro_torch.training.optimizer import init_opt_state
    model = _reduced_lm()
    params = model.init(torch.Generator(device=cuda_device).manual_seed(2))
    state = {"params": params, "opt": init_opt_state(params)}
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    ck.save(3, state, extra={"step": 3})
    before = dict(ops.LAUNCHES)
    out = ck.restore(device=cuda_device)
    assert all(ops.LAUNCHES[k] > before[k] for k in before)
    assert out.pop("_manifest")["extra"]["step"] == 3
    for k, v in params.items():
        got = out["params"][k]
        assert got.device.type == "cuda" and got.dtype == v.dtype
        assert torch.equal(got, v), k
    assert out["opt"]["step"].dtype == torch.int32
    assert int(out["opt"]["step"]) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_on_the_card_match_the_cpu(cuda_device, dtype):
    """Eight teacher-forced reduced-config decode steps from the same
    weights: each step's logits within 1e-4 (fp32) or 2e-2 (bf16)
    relative norm of the CPU's, the caches alike; the write slot and
    the positions never leave the card."""
    model = _reduced_lm()
    params = model.init(torch.Generator().manual_seed(6),
                        getattr(torch, dtype))
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (3, 8)).astype(np.int32))
    out = {}
    for dev in ("cpu", cuda_device):
        p = {k: v.to(dev) for k, v in params.items()}
        cache = model.init_cache(3, 8, dtype=getattr(torch, dtype),
                                 device=dev)
        logits = []
        with torch.no_grad():
            for t in range(toks.shape[1]):
                lg, cache = model.decode_step(p, cache,
                                              toks[:, t:t + 1].to(dev))
                logits.append(lg.float().cpu())
        out[str(dev)] = (logits, {k: v.cpu() for k, v in cache.items()})
    (lc, cc), (lg, cg) = out["cpu"], out[str(cuda_device)]
    tol = 1e-4 if dtype == "float32" else 2e-2
    errs = [_rel(a, b) for a, b in zip(lc, lg)]
    print(f"decode card vs cpu {dtype}: worst step {max(errs):.3e}")
    assert max(errs) <= tol, errs
    for k in ("k", "v"):
        assert _rel(cc[k].float(), cg[k].float()) <= tol, k
    assert torch.equal(cc["pos"], cg["pos"]) and int(cg["pos"][0]) == 8


def test_serve_session_on_the_card(cuda_device, monkeypatch):
    """`ServeSession.serve_reads` from a store on the card: contexts
    fetched through both kernels, greedy tokens in range, equal to the
    CPU's in fp32 (fp32 weights and an fp32 cache)."""
    import functools
    from repro_torch.api.archive import GenomicArchive
    from repro_torch.serving import ServeConfig, ServeSession
    data = make_fastq("platinum", n_reads=400, seed=41)
    model = _reduced_lm()
    monkeypatch.setattr(model, "init_cache", functools.partial(
        type(model).init_cache, model, dtype=torch.float32))
    params = model.init(torch.Generator().manual_seed(7), torch.float32)
    got = {}
    for dev in ("cpu", cuda_device):
        ga = GenomicArchive.from_bytes(data, block_size=4096, device=dev)
        p = {k: v.to(dev) for k, v in params.items()}
        sess = ServeSession(model, p, ServeConfig(max_seq=24), store=ga)
        before = dict(ops.LAUNCHES)
        got[str(dev)] = sess.serve_reads([5, 77, 301], 16, 6)
        if dev != "cpu":
            assert all(ops.LAUNCHES[k] > before[k] for k in before)
    want = got["cpu"]
    assert want.shape == (3, 6) and (want >= 0).all() \
        and (want < model.cfg.vocab).all()
    np.testing.assert_array_equal(got[str(cuda_device)], want)


def test_autotune_on_the_card_decodes_bit_for_bit(cuda_device):
    """A reduced sweep of the default grid on the card: every point's
    ratio is a CPU encode's, readings are positive, and the chosen
    profile's archive decodes the corpus bit for bit on the card."""
    from repro_torch.api.archive import GenomicArchive
    from repro_torch.tune import EncodeProfile, autotune
    data = make_fastq("platinum", n_reads=1200, seed=43)
    res = autotune(data, target="seek", sample_bytes=256 * 1024, iters=1,
                   device=cuda_device)
    assert len(res.points) == 8 and not res.skipped
    sample = data[:256 * 1024]
    for p in res.points:
        assert p.ratio == encode(sample, profile=p.profile).ratio
        assert p.seek_us > 0 and p.decode_GBps > 0
    assert isinstance(res.profile, EncodeProfile)
    ga = GenomicArchive.create(data, profile=res.profile,
                               device=cuda_device)
    assert ga.profile == res.profile
    assert ga.store.decoder.decode_all().tobytes() == data


@pytest.mark.parametrize("entropy", ["rans", "raw"])
def test_tuner_64KiB_ra_blocks_on_the_card(cuda_device, entropy):
    """The default grid's 64 KiB "ra" points (4 offset planes, the match
    kernel's pointers in global scratch) on a 1 MiB sample: the card's
    rows equal the plain path's and the source, whole and one block at
    a time (the tuner's seek)."""
    data = make_fastq("platinum", n_reads=5000, seed=44)[:1 << 20]
    a = encode(data, block_size=64 * 1024, entropy=entropy)
    assert a.offset_bytes == 4 and a.n_blocks == 16
    card = dec.Decoder(a, device=cuda_device)
    plain = dec.Decoder(a, device="cpu")
    before = dict(ops.LAUNCHES)
    rows = card.decode_blocks(np.arange(a.n_blocks))
    assert ops.LAUNCHES["lz77_match"] > before["lz77_match"]
    assert torch.equal(rows.cpu(), plain.decode_blocks(
        np.arange(a.n_blocks)))
    assert rows.reshape(-1)[:len(data)].cpu().numpy().tobytes() == data
    one = card.decode_blocks(np.array([8]))
    assert torch.equal(one.cpu(), rows[8:9].cpu())


# ------------------------------------------------- multi-device residency
def _shard_mesh(device, n=4):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((n,), ("data",), [device] * n)


def test_partition_on_the_card_equals_the_cpu(cuda_device):
    """A 4-shard partition on one card: bounds, per-shard bytes, rows and
    counters equal to the same partition over four `cpu` shards, through
    the partitioned decode, the sharded executor with a per-shard cache
    and sharded streaming; every shard decode launches both kernels."""
    from repro_torch.api.address import ByteRange
    from repro_torch.api.executors import ShardedExecutor, StreamingExecutor
    from repro_torch.core.residency import CompressedResidentStore
    from repro_torch.core.sharded_decode import (partition_archive,
                                                 partitioned_decode_blocks)
    data = make_fastq("platinum", n_reads=2000, seed=61)
    a = encode(data, block_size=4096)
    out = {}
    for name, device in (("card", cuda_device), ("cpu", "cpu")):
        s = CompressedResidentStore(a, device=device)
        part = partition_archive(s.decoder, _shard_mesh(device))
        assert all(sh.device.type == torch.device(device).type
                   for sh in part.shards)
        sel = np.random.default_rng(3).permutation(a.n_blocks)[:37]
        before = dict(ops.LAUNCHES)
        rows = partitioned_decode_blocks(s.decoder, part, sel, verify=True)
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
        got = [part.bounds.tolist(), part.per_shard_device_bytes,
               rows.cpu(), s.decoder.launch_rounds_last,
               s.decoder.decoded_blocks_last]
        sx = ShardedExecutor(s, _shard_mesh(device), cache_blocks=16)
        planner = s._api()[0]
        bs = a.block_size
        for rep in range(3):
            ids = np.random.default_rng(rep % 2).integers(0, a.n_blocks, 24)
            r, _ = sx.run(planner.plan_spans(ids * bs + 7,
                                             np.full(ids.size, 100)))
            got += [r.cpu(), sx.cache_info()]
        st = StreamingExecutor(s, max_resident_bytes=6 * bs,
                               sharded=sx.sharded)
        got.append(np.concatenate(list(st.chunks([ByteRange(0, len(data))]))))
        got.append([tuple(vars(c).values()) for c in st.chunk_log])
        out[name] = (got, launched)
    card, cpu = out["card"][0], out["cpu"][0]
    assert len(card) == len(cpu)
    for x, y in zip(card, cpu):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y)
        else:
            assert x == y
    assert card[-2].tobytes() == data
    # one launch of each kernel a shard and depth bucket
    n_buckets = len(card[3])
    assert out["card"][1] == {"rans_decode": 4 * n_buckets,
                              "lz77_match": 4 * n_buckets}


def test_shard_loss_heals_on_the_card(cuda_device):
    """`drop_shard` zeroes a shard's words on the card; a verified
    `rows_for_blocks` under "repair" heals from the host copy, re-seeds
    the partition in place and returns the source bytes."""
    from repro_torch.core.residency import CompressedResidentStore
    from repro_torch.resilience.faults import FaultInjector
    data = make_fastq("platinum", n_reads=2000, seed=62)
    a = encode(data, block_size=4096)
    s = CompressedResidentStore(a, device=cuda_device)
    sr = s.attach_sharded(_shard_mesh(cuda_device), verify=True,
                          on_error="repair", cache_blocks=8)
    uniq = np.arange(a.n_blocks)
    want = sr.rows_for_blocks(uniq).cpu()
    assert want.reshape(-1)[:len(data)].numpy().tobytes() == data
    ev = FaultInjector(seed=18).drop_shard(sr, shard=1)
    assert ev["shard"] == 1 and not sr.part.shards[1].words.any()
    words = sr.part.shards[1].words
    got = sr.rows_for_blocks(uniq).cpu()
    assert torch.equal(got, want)
    assert sr.shard_rebuilds == 1
    assert sr.part.shards[1].words is words and words.any()


def test_world_of_one_dp_step_on_the_card_equals_the_plain_step(
        cuda_device):
    """An NCCL world of one: the uncompressed data-parallel step is the
    plain step bit for bit; the compressed step's loss is the plain
    loss, and `compressed_psum` stays within one quantum."""
    from repro_torch.launch.mesh import dp_group, make_local_mesh
    from repro_torch.training import grad_compress as gc
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_manual_dp_step,
                                                 make_train_step)
    model = _reduced_lm()
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    tokens = (torch.arange(8 * 32, device=cuda_device).reshape(8, 32)
              % 512).to(torch.int32)
    batch = {"tokens": tokens, "labels": tokens}

    def fresh():
        return init_train_state(
            model, torch.Generator(device=cuda_device).manual_seed(0), opt,
            torch.float32)

    plain, pm = make_train_step(model, opt, remat="none")(fresh(), batch)
    with dp_group(cuda_device):
        mesh = make_local_mesh()
        assert mesh.size == 1
        dp, dm = make_manual_dp_step(model, opt, mesh, remat="none")(
            fresh(), batch, 0)
        _, cm = make_manual_dp_step(model, opt, mesh, remat="none",
                                    compress=True)(fresh(), batch, 0)
        x = torch.randn(4096, device=cuda_device) * 3
        got = gc.compressed_psum(x, gc.leaf_generator(1, 0, cuda_device))
        scale = float(x.abs().max()) / 127
    assert torch.equal(pm["loss"], dm["loss"])
    assert torch.equal(pm["loss"], cm["loss"])
    for k in plain["params"]:
        assert torch.equal(plain["params"][k], dp["params"][k]), k
    assert float((got - x).abs().max()) <= scale * 1.01


def test_launchers_restore_the_current_device(cuda_device):
    """Each launcher makes its tensors' card current and restores the
    caller's current device before it returns."""
    n = torch.cuda.device_count()
    data = make_fastq("platinum", n_reads=200, seed=63)
    a = encode(data, block_size=4096)
    for d in range(n):
        dev = torch.device("cuda", d)
        decoder = dec.Decoder(a, device=dev)
        torch.cuda.set_device((d + 1) % n)
        try:
            before = dict(ops.LAUNCHES)
            rows = decoder.decode_blocks(np.arange(a.n_blocks))
            ops.lz77_occupancy(4096, 256, dev)
            assert torch.cuda.current_device() == (d + 1) % n
            assert all(ops.LAUNCHES[k] > before[k] for k in before)
            assert rows.device == dev
        finally:
            torch.cuda.set_device(0)
    assert rows.reshape(-1)[:len(data)].cpu().numpy().tobytes() == data


# ------------------------------------------------- non-dense families
FAMILIES = ("qwen3-moe-235b-a22b", "xlstm-350m", "recurrentgemma-2b",
            "whisper-medium", "qwen2-vl-2b")


def _family_batch(cfg, dev, B=2, S=32):
    """Seeded tokens and the family's extra inputs (frames; image
    embeddings and M-RoPE ids) on `dev`."""
    g = torch.Generator().manual_seed(9)
    toks = torch.randint(0, 256, (B, S + 1), generator=g, dtype=torch.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "whisper":
        b["frames"] = torch.randn((B, cfg.n_frames, cfg.d_model),
                                  generator=g)
    if cfg.family == "vlm":
        b["img_embeds"] = torch.randn((B, cfg.n_img_tokens, cfg.d_model),
                                      generator=g)
        p = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
        b["mrope"] = torch.stack([p, p, p])
    return {k: v.to(dev) for k, v in b.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_step_on_the_card_matches_the_cpu(cuda_device, arch):
    """One reduced fp32 train step a family from the same weights and
    batch: the loss within 1e-4 and the gradient norm within 1e-3
    relative of the CPU's, and the new params within 1e-3 relative norm
    (worst readings on an H100: loss 7.7e-8, gradient norm 2.4e-5,
    params 1.2e-4, recurrentgemma's: its sqrt(1 - exp(2·a_log)) cancels
    as a_log → 0, so one ulp of exp moves it by about 1e-4; every other
    family's 2.0e-5 or less. The test prints them under `pytest -s`)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = model.init(torch.Generator().manual_seed(4), torch.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        p = {k: v.to(dev, copy=True) for k, v in params.items()}
        st = {"params": p, "opt": init_opt_state(p)}
        st, m = make_train_step(model, opt, remat="none")(
            st, _family_batch(cfg, dev))
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]),
                         {k: v.cpu() for k, v in st["params"].items()})
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out[str(cuda_device)]
    prel = max(_rel(pc[k], pg[k]) for k in pc)
    print(f"{arch} card vs cpu: loss {abs(lg - lc) / abs(lc):.3e} "
          f"grad_norm {abs(gg - gc) / abs(gc):.3e} params {prel:.3e}")
    assert abs(lg - lc) <= 1e-4 * abs(lc), (lg, lc)
    assert abs(gg - gc) <= 1e-3 * abs(gc), (gg, gc)
    assert prel <= 1e-3, prel


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_decode_steps_on_the_card_match_the_cpu(cuda_device, arch):
    """Eight teacher-forced reduced fp32 decode steps a family (Whisper's
    cross cache primed from frames): every step's logits within 1e-3
    relative norm of the CPU's, the cache alike (worst readings on an
    H100: recurrentgemma 4.3e-4, for the reason given above; every other
    family 4.9e-6 or less)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(6), torch.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        p = {k: v.to(dev) for k, v in params.items()}
        b = _family_batch(cfg, dev, S=8)
        kw = ({"params": p, "frames": b["frames"]}
              if cfg.family == "whisper" else {})
        cache = model.init_cache(2, 12, dtype=torch.float32, device=dev,
                                 **kw)
        logits = []
        with torch.no_grad():
            for t in range(8):
                lg, cache = model.decode_step(p, cache,
                                              b["tokens"][:, t:t + 1])
                logits.append(lg.cpu())
        out[str(dev)] = (logits, {k: v.cpu() for k, v in cache.items()})
    (lc, cc), (lg, cg) = out["cpu"], out[str(cuda_device)]
    errs = [_rel(a, b) for a, b in zip(lc, lg)]
    print(f"{arch} decode card vs cpu: worst step {max(errs):.3e}")
    assert max(errs) <= 1e-3, errs
    for k in cc:
        if k == "pos":
            assert torch.equal(cc[k], cg[k]) and int(cg[k][0]) == 8
        else:
            assert _rel(cc[k], cg[k]) <= 1e-3, k


# ------------------------------------------------------------- roofline
@pytest.mark.parametrize("arch", ("qwen2-1.5b",) + FAMILIES)
def test_step_counted_on_the_card_equals_the_meta_count(cuda_device, arch):
    """One reduced bf16 train step and one decode step a family, counted
    on the card under the dry-run's counting mode: the FLOPs equal those
    counted on meta tensors of the same shapes."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.roofline.step import count_step, meta_like
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    opt = AdamWConfig()
    state = init_train_state(
        model, torch.Generator(device=cuda_device).manual_seed(0), opt)
    b = _family_batch(cfg, cuda_device)
    step = make_train_step(model, opt, remat="none")
    card = count_step(step, state, b, device=cuda_device)
    meta = count_step(step, *meta_like((state, b)), device="meta")
    assert card["flops"] == meta["flops"] > 0
    assert card["bytes"] > 0 and meta["bytes"] > 0
    cache = model.init_cache(2, 40, device=cuda_device)
    cur = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)

    def decode(p, c, t):
        with torch.no_grad():
            return model.decode_step(p, c, t)

    card = count_step(decode, state["params"], cache, cur,
                      device=cuda_device)
    meta = count_step(decode, *meta_like((state["params"], cache, cur)),
                      device="meta")
    assert card["flops"] == meta["flops"] > 0


def test_mfu_of_a_timed_step_is_a_share(cuda_device):
    """A timed full-width qwen2-1.5b train step at 2 layers (B=2, T=255):
    its MFU and roofline share lie in (0, 1]."""
    import dataclasses
    import time
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.roofline import hlo_costs as rl
    from repro_torch.roofline.step import count_step, step_roofline
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2)
    model = build_model(cfg)
    opt = AdamWConfig()
    state = init_train_state(
        model, torch.Generator(device=cuda_device).manual_seed(0), opt)
    toks = torch.randint(0, 256, (2, 256), device=cuda_device)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(model, opt, remat="none")
    state, _ = step(state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, b)
    float(m["loss"])
    step_s = time.perf_counter() - t0
    r = step_roofline(rl.model_flops_train(cfg, 2 * 255),
                      count_step(step, state, b, device=cuda_device), step_s)
    print(f"mfu {r['mfu']:.4f} roofline share {r['roofline_share']:.4f} "
          f"({r['bound_by']})")
    assert 0 < r["mfu"] <= 1 and 0 < r["roofline_share"] <= 1


# ------------------------------------------------------------- dry-run
@pytest.mark.parametrize("cell", ["tiny_train", "train_4k"])
def test_dense_train_cell_counts_on_this_pytorch(cell):
    """The dry-run's dense train cells counted on this machine's own
    PyTorch, whose DTensor may place a product otherwise than the one the
    CPU tests run on: the reduced cell (qwen2-1.5b cut to 2 layers, B=8 x
    T=64 on a (4, 2) mesh) and qwen2-1.5b's train_4k on the single-pod
    (16, 16) mesh, both in a fake world. The FLOPs times the devices lie
    within 1.0-2.0x the model FLOPs 6·N·D, and the ops DTensor refused,
    run replicated by `CostMode`, carry at most 0.2 of the collective
    bytes; train_4k's `temp` (the loss gradient's zeros per shard) stays
    below 128 GB. Host work on meta tensors: no card is needed."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.roofline import hlo_costs as rl
    if cell == "tiny_train":
        mesh = make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
        cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                                  n_layers=2)
        fn, args, in_sh, _, _, _ = dr.build_cell(
            cfg, ShapeConfig("tiny_train", 64, 8, "train"), mesh)
        m = dr.count_cell(fn, args, in_sh, mesh, dr.rules_for(cfg))
        n_dev, model_flops = mesh.size, rl.model_flops_train(cfg, 8 * 64)
    else:
        rec = dr.run_cell("qwen2-1.5b", cell, "single", verbose=False)
        m = {"flops": rec["flops_per_device"],
             "temp": rec["memory_analysis"]["temp_size_in_bytes"],
             "fb_replicate_bytes": rec["fallbacks"]["replicate"]["bytes"],
             **{f"coll_{k}": v
                for k, v in rec["coll_bytes_per_device"].items()}}
        n_dev, model_flops = rec["n_devices"], rec["model_flops"]
    ratio = m["flops"] * n_dev / model_flops
    coll = sum(v for k, v in m.items() if k.startswith("coll_"))
    share = m["fb_replicate_bytes"] / coll
    print(f"torch {torch.__version__}, {cell}: flops x devices / model "
          f"flops {ratio:.3f}, replicate share {share:.3f}, "
          f"temp {m['temp']:.4e} B, collectives "
          f"{ {k[5:]: v for k, v in m.items() if k.startswith('coll_')} }")
    assert 1.0 <= ratio <= 2.0, ratio
    assert share <= 0.2, share
    if cell == "train_4k":
        assert m["temp"] < 128e9, m["temp"]
