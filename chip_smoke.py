#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It builds both
CUDA kernels from `src/repro_torch/csrc/` with nvcc, holds each against
its plain PyTorch version, then drives the port's main path — Mode 2
device-resident decode of an "ra" archive and `fetch_reads` random
access — over an 8 GiB FASTQ corpus resident as compressed words, and
the paths of the query plane: global (anchored wavefront) archives
through `GenomicArchive` (64 MiB anchored, 16 MiB anchor-free, 1 MiB
placed across 2^32), Mode 1, VRAM-budgeted streaming of the 8 GiB
archive, the decoded-block cache under Zipf traffic, and the
self-healing and serving planes: an 8 GiB parity-protected store healed
on the card (`on_error="repair"` through decode_all, cached fetches and
a stream), a parity group corrupted twice and served as typed
`ReadCorrupt` results (`on_error="partial"`), and two tenants of a
`ServingFrontend` over the 8 GiB store under closed-loop traffic. It
checks every decoded and served byte against the source. Each phase
prints one JSON line; the last line is `{"ok": true, "device": {...}}`.
Any mismatch or failure exits non-zero; without a CUDA card it exits
non-zero at once.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BLOCK = 16 * 1024                 # DEFAULT_BLOCK_SIZE, the serving block
CORPUS_BLOCKS = 1024              # 16 MiB encoded once on the host ...
TILES = 512                       # ... and tiled to 8 GiB resident
CHUNK = 4096                      # decode_all chunk: 64 MiB of output
GLOBAL_BLOCKS = 4096              # anchored global archive: 64 MiB ...
ANCHOR = 4                        # ... with an anchor every 4 blocks
FREE_BLOCKS = 1024                # anchor-free global archive: 16 MiB
WRAP_BLOCKS = 64                  # 1 MiB placed across 2^32:
WRAP_ORIGIN = 2**32 - 2**19 + 17  # its low 32 bits wrap mid-archive
STREAM_BUDGET = 256 << 20         # max_resident_bytes of the stream phase
CACHE_BLOCKS = 8192               # cache phase: 128 MiB of decoded slots
HEAL_GROUP = 8                    # heal phase: XOR parity over 8 blocks ...
HEAL_FLIPS = 64                   # ... one word flipped in each of 64 groups
HEAL_CHUNK = 65536                # verified decode_all chunk: 1 GiB
HEAL_CACHE = 1024                 # the parity store's decoded-block cache
SERVE_FLOOR = 2048                # serve phase: CACHE_BLOCKS slots, this
                                  # floor for each of two tenants
SERVE_KEYS = 1 << 16              # Zipf keys, spread over every read id
SERVE_DEADLINE_US = 100_000.0     # the priority-0 tenant's deadline
SERVE_REQUESTS = 4096             # requests a tenant ...
SERVE_CONCURRENCY = 32            # ... with this many outstanding
SEED = 12
DEVICE = "cuda"
# peak rates of one H100 SXM: HBM bytes/s (published data sheet) and the
# issue rate of 32-bit integer instructions, 132 SMs x 4 schedulers x 32
# lanes x 1.98 GHz boost clock = 33.5e12 lane-ops/s. (The 67e12 used
# before is the fp32 FLOP rate, which counts each FMA as two operations:
# an integer instruction is one, so it halved every operations bound.)
PEAK_BYTES = 3.35e12
PEAK_OPS = 132 * 4 * 32 * 1.98e9
# integer operations per unit of work, counted from the kernel sources
RANS_OPS_PER_LANE_STEP = 10       # slot mask, table load, 2 field
                                  # extracts, shift, multiply-add, compare,
                                  # ballot, popc, store
LZ77_OPS_PER_BYTE = 2             # what LZ77 decode needs: load the
                                  # byte's source, store the byte
# what this kernel's algorithm issues, a per-layer note and not its bound
LZ77_KERNEL_OPS_PER_BYTE = 16     # fill: offset, compare, select, fold,
                                  # clamp, compare, store; payout: load,
                                  # negate, clamp, literal load, pack
LZ77_KERNEL_OPS_PER_BYTE_ROUND = 6  # load, compare, gather, select, store,
                                    # moved flag


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sync() -> None:
    import torch
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` launches, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, kernel: str, reps: int) -> float:
    """Mean device duration of the CUDA kernel whose name holds `kernel`
    over `reps` calls of `fn`, from the profiler's kernel records: host
    time between launches, which CUDA events around back-to-back calls
    would count, is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and kernel in e.name]
    if len(us) != reps:
        fail(f"profiler saw {len(us)} launches of {kernel}, not {reps}")
    return sum(us) / reps / 1e3


def max_abs_err(a, b) -> int:
    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.int() - b.int()).abs().max()) if a.numel() else 0


# ------------------------------------------------------------------ phases
def phase_device():
    import torch
    from repro_torch.kernels import _build, ops
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    # the match kernel at the 16 KiB block, with room for twice the
    # command slots the main path's archive needs (569)
    occ = ops.lz77_occupancy(BLOCK, BLOCK // 16, DEVICE)
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "ptxas": {k: [ln for ln in v.splitlines() if "Used" in ln]
                    for k, v in _build.ptxas_info.items()},
          "lz77_match_at_16KiB_1024_cmds": occ})
    if occ["pointer_bytes"] != 2 or occ["ctas_per_sm"] < 2:
        fail(f"lz77_match at 16 KiB blocks: {occ}")
    return smi


def phase_kernels_vs_plain():
    """Both kernels against their plain versions, byte for byte, at
    blocks of 512 B, 1000 B and 3001 B (rows that are not a multiple of 16
    or 8 bytes, so the match kernel's per-element rounds and per-byte
    stores), 16 KiB, 32 KiB (the last 16-bit pointer size) and 1 MiB (4
    offset planes, i32 pointers in global scratch), for rANS CTAs of 1, 4,
    8 and 16 blocks, with the archive's rounds, the early-exit resolver and
    one round short."""
    import torch
    from repro_torch.core import decoder as dec
    from repro_torch.core.encoder import encode
    from repro_torch.data.fastq import make_fastq
    from repro_torch.kernels import ops, ref
    cases = []
    for block, n_reads, kind in ((512, 1200, "noisy"),
                                 (1000, 1200, "noisy"),
                                 (3001, 1200, "platinum"),
                                 (16 * 1024, 5000, "platinum"),
                                 (32 * 1024, 5000, "noisy"),
                                 (1024 * 1024, 12000, "platinum")):
        data = make_fastq(kind, n_reads=n_reads, seed=SEED)
        a = encode(data, block_size=block)
        da = dec.to_device(a, DEVICE)
        sel = torch.arange(a.n_blocks, device=DEVICE)
        rin = dec._rans_inputs(da, sel)
        plain_rows = ref.rans_decode_streams_ref(**rin)
        rans_err = 0
        for group in (1, 4, 8, 16):
            rows = ops.rans_decode_streams(**rin, group=group)
            sync()
            rans_err = max(rans_err, max_abs_err(rows, plain_rows))
        m = dec._match_inputs(da, da.layout.split(plain_rows), sel)
        src = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
        rounds = [a.max_depth, None, max(a.max_depth - 1, 0)]
        lz_err = 0
        for r in rounds:
            got = ops.lz77_decode_planes(**m, n_rounds=r)
            sync()
            lz_err = max(lz_err, max_abs_err(
                got, ref.lz77_decode_planes_ref(**m, n_rounds=r)))
            if r is not None and r == a.max_depth:
                flat = got.reshape(-1)[:len(data)].cpu()
                if not torch.equal(flat, src):
                    fail(f"lz77_match at block {block} is not the source")
        if rans_err or lz_err:
            fail(f"kernel differs from its plain version at block {block}: "
                 f"rans {rans_err}, lz77 {lz_err}")
        cases.append({"block_size": block, "offset_bytes": a.offset_bytes,
                      "blocks": a.n_blocks, "max_cmds": da.max_cmds,
                      "max_depth": a.max_depth,
                      "rans_groups": [1, 4, 8, 16], "lz77_rounds": rounds,
                      "rans_max_abs_err": rans_err,
                      "lz77_max_abs_err": lz_err,
                      "lz77_config": ops.lz77_occupancy(
                          block, da.max_cmds, DEVICE)})
    # rANS on a global archive's layout: 8 offset planes a command
    data = make_fastq("platinum", n_reads=5000, seed=SEED)
    a = encode(data, block_size=16 * 1024, mode="global",
               anchor_interval=ANCHOR)
    da = dec.to_device(a, DEVICE)
    rin = dec._rans_inputs(da, torch.arange(a.n_blocks, device=DEVICE))
    plain_rows = ref.rans_decode_streams_ref(**rin)
    err = 0
    for group in (1, 4, 8, 16):
        rows = ops.rans_decode_streams(**rin, group=group)
        sync()
        err = max(err, max_abs_err(rows, plain_rows))
    host = dec._entropy_decode_host(a, np.arange(a.n_blocks), da.max_cmds)
    for name, col in da.layout.split(rows).items():
        if not np.array_equal(col.cpu().numpy(), host[name]):
            fail(f"rans_decode's {name} of a global archive differ from "
                 f"the host decode")
    cases.append({"case": "rans_decode, global layout",
                  "offset_bytes": a.offset_bytes, "blocks": a.n_blocks,
                  "layout": da.layout.starts, "rans_groups": [1, 4, 8, 16],
                  "rans_max_abs_err": err, "lz77_max_abs_err": 0})
    # lz77_match on Mode 1's host planes, uploaded as separate tensors
    # (rows of 1000 B are not 16-byte aligned)
    for block in (1000, 16 * 1024):
        data = make_fastq("noisy", n_reads=1200, seed=SEED + 1)
        a = encode(data, block_size=block)
        da = dec.to_device(a, DEVICE)
        sel = torch.arange(a.n_blocks, device=DEVICE)
        streams = {k: torch.from_numpy(v).to(DEVICE) for k, v in
                   dec._entropy_decode_host(a, np.arange(a.n_blocks),
                                            da.max_cmds).items()}
        m = dec._match_inputs(da, streams, sel)
        err = 0
        for r in (a.max_depth, None):
            got = ops.lz77_decode_planes(**m, n_rounds=r)
            sync()
            err = max(err, max_abs_err(
                got, ref.lz77_decode_planes_ref(**m, n_rounds=r)))
        if got.reshape(-1)[:len(data)].cpu().numpy().tobytes() != data:
            fail(f"lz77_match on host planes at block {block} is not the "
                 f"source")
        cases.append({"case": "lz77_match, Mode 1 host planes",
                      "block_size": block, "blocks": a.n_blocks,
                      "row_strides": {k: v.stride(0)
                                      for k, v in streams.items()},
                      "rans_max_abs_err": 0, "lz77_max_abs_err": err})
    emit({"phase": "kernels_vs_plain", "cases": cases})
    worst = max(max(c["rans_max_abs_err"], c["lz77_max_abs_err"])
                for c in cases)
    if worst:
        fail(f"a kernel differs from its plain version: {cases[-3:]}")
    return worst


def phase_resident():
    from repro_torch.core.encoder import encode
    from repro_torch.core.index import ReadIndex
    from repro_torch.core.residency import CompressedResidentStore
    from repro_torch.data.tiling import aligned_fastq, tile_archive, tile_index
    import torch
    t0 = time.perf_counter()
    corpus = aligned_fastq(CORPUS_BLOCKS, BLOCK, seed=SEED)
    a = encode(corpus, block_size=BLOCK)
    encode_s = time.perf_counter() - t0
    index = ReadIndex.build(corpus, BLOCK)
    tiled = tile_archive(a, TILES)
    store = CompressedResidentStore(
        tiled, tile_index(index, TILES, len(corpus)), device=DEVICE)
    sync()
    st = store.stats()
    emit({"phase": "resident", "encode_s": encode_s,
          "corpus_bytes": len(corpus), "tiles": TILES,
          "raw_bytes": st.raw_size, "n_blocks": st.n_blocks,
          "n_reads": store.index.n_reads, "words": int(tiled.words.size),
          "compressed_device_bytes": st.compressed_device_bytes,
          "residency_fraction_of_raw": st.residency_fraction_of_raw,
          "max_depth": tiled.max_depth,
          "depth_buckets": sorted(set(store.decoder.block_rounds.tolist())),
          "max_read_start": int(store.index.starts[-2]),
          "device_memory_allocated": (torch.cuda.memory_allocated()
                                      if DEVICE == "cuda" else None)})
    return corpus, index, store, tiled, a


def check_tiled(chunk: np.ndarray, pos: int, src: np.ndarray,
                what: str) -> None:
    """`chunk` must equal bytes [pos, pos + chunk.size) of the corpus
    `src` tiled end to end."""
    n, i = src.size, 0
    while i < chunk.size:
        o = (pos + i) % n
        take = min(n - o, chunk.size - i)
        if not np.array_equal(chunk[i:i + take], src[o:o + take]):
            fail(f"{what}: bytes at {pos + i} are not the source")
        i += take


def check_all(out: np.ndarray, src: np.ndarray, what: str) -> None:
    """`out` must be the whole tiled corpus, tile by tile."""
    n = src.size
    if out.size != n * TILES or any(
            not np.array_equal(out[t * n:(t + 1) * n], src)
            for t in range(TILES)):
        fail(f"{what} is not bit-perfect against the source")


def phase_decode(corpus, store):
    import torch
    from repro_torch.kernels import ops
    dec = store.decoder
    n = len(corpus)
    src = np.frombuffer(corpus, np.uint8)
    ops.reset_launches()
    t0 = time.perf_counter()
    out = dec.decode_all(chunk_blocks=CHUNK)
    decode_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    check_all(out, src, "decode_all")
    del out
    # once more, past the first call's warm-up
    t0 = time.perf_counter()
    out = dec.decode_all(chunk_blocks=CHUNK)
    again_s = time.perf_counter() - t0
    check_tiled(out[:n], 0, src, "decode_all (again)")
    check_tiled(out[-n:], out.size - n, src, "decode_all (again)")
    del out
    chunks = -(-dec.da.n_blocks // CHUNK)
    # one chunk past 4 GiB decodes again with on-device digest checks
    lo = (dec.da.n_blocks // 2 + CHUNK) // CHUNK * CHUNK
    ops.reset_launches()
    t0 = time.perf_counter()
    rows = dec.decode_blocks(np.arange(lo, lo + CHUNK), verify=True)
    sync()
    verified_s = time.perf_counter() - t0
    for k, v in ops.LAUNCHES.items():
        launches[k] += v
    per_tile = n // BLOCK
    want = np.tile(src.reshape(per_tile, BLOCK), (CHUNK // per_tile + 1, 1))
    off = lo % per_tile
    if not np.array_equal(rows.cpu().numpy(), want[off:off + CHUNK]):
        fail("the verified chunk is not the source")
    del rows
    emit({"phase": "decode", "raw_bytes": n * TILES, "chunks": chunks,
          "chunk_blocks": CHUNK, "decode_s": decode_s,
          "decode_GBps": n * TILES / decode_s / 1e9, "again_s": again_s,
          "again_GBps": n * TILES / again_s / 1e9,
          "verified_chunk_first_block": lo, "verified_s": verified_s,
          "bit_perfect": True, "launches": launches,
          "launches_per_chunk": {k: v / (chunks + 1)
                                 for k, v in launches.items()}})
    return launches, chunks + 1


def _check_reads(out, lens, ids, corpus, starts):
    n_reads = starts.size - 1
    out = out.cpu().numpy()
    lens = lens.cpu().numpy()
    for i, r in enumerate(ids):
        s, e = int(starts[r % n_reads]), int(starts[r % n_reads + 1])
        if lens[i] != e - s or out[i, :e - s].tobytes() != corpus[s:e] \
                or out[i, e - s:].any():
            fail(f"fetch_reads returned wrong bytes for read {int(r)}")


def phase_fetch(corpus, index, store):
    import torch
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED)
    starts = np.asarray(index.starts, np.int64)
    n_reads = store.index.n_reads
    store.fetch_reads(rng.integers(0, n_reads, 256))      # warm-up
    sync()
    ops.reset_launches()
    b1_ms = []
    b1_ids = rng.integers(0, n_reads, 200)
    b1 = []
    for r in b1_ids:
        t0 = time.perf_counter()
        out, lens = store.fetch_reads([int(r)])
        sync()
        b1_ms.append((time.perf_counter() - t0) * 1e3)
        b1.append((out, lens, [r]))
    b1_launches = dict(ops.LAUNCHES)
    n_b256 = 24
    b256_ids = [rng.integers(0, n_reads, 256) for _ in range(n_b256)]
    b256 = []
    t0 = time.perf_counter()
    for ids in b256_ids:
        b256.append((*store.fetch_reads(ids), ids))
    sync()
    b256_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for out, lens, ids in b1 + b256:
        _check_reads(out, lens, ids, corpus, starts)
    emit({"phase": "fetch", "n_reads": n_reads,
          "b1_calls": len(b1_ids),
          "b1_p50_ms": float(np.percentile(b1_ms, 50)),
          "b1_p90_ms": float(np.percentile(b1_ms, 90)),
          "b256_batches": n_b256,
          "b256_reads_per_s": 256 * n_b256 / b256_s,
          "b256_ms_per_batch": b256_s * 1e3 / n_b256,
          "reads_checked": len(b1_ids) + 256 * n_b256,
          "launches": launches,
          "launches_per_b1_fetch": {k: v / len(b1_ids)
                                    for k, v in b1_launches.items()},
          "launches_per_b256_fetch": {
              k: (v - b1_launches[k]) / n_b256 for k, v in launches.items()}})
    return launches, len(b1_ids) + n_b256


def phase_timing(store):
    """Both kernels at the shapes of one decode chunk of the main path,
    beside their plain versions and their bounds."""
    import torch
    from repro_torch.core import decoder as dec
    from repro_torch.core.format import S_LITERALS
    from repro_torch.kernels import ops, ref
    d = store.decoder
    da = d.da
    sel_np = np.arange(CHUNK)
    sel = torch.arange(CHUNK, device=d.device)
    rin = dec._rans_inputs(da, sel)
    rows = ops.rans_decode_streams(**rin)
    plain_rows = ref.rans_decode_streams_ref(**rin)
    rans_err = max_abs_err(rows, plain_rows)
    rans_ms = kernel_ms(lambda: ops.rans_decode_streams(**rin),
                        "rans_decode_kernel", 20)
    rans_ms_by_group = {g: kernel_ms(
        lambda: ops.rans_decode_streams(**rin, group=g),
        "rans_decode_kernel", 5) for g in (1, 4, 8, 16)}
    rans_call_ms = time_ms(lambda: ops.rans_decode_streams(**rin), 20)
    rans_plain_ms = time_ms(lambda: ref.rans_decode_streams_ref(**rin), 2)
    a = d.archive
    lanes = np.maximum(a.lanes[sel_np].astype(np.int64), 1)
    nsym = a.n_syms[sel_np].astype(np.int64)
    nwords = a.n_words[sel_np].astype(np.int64)
    S = nsym.size
    rans_bytes = (2 * int((2 * lanes + nwords).sum())      # stream words
                  + S * (8 + 4 + 4)                        # stream table
                  + 4 * 4096 * 4                           # slot tables
                  + rows.numel())                          # stream rows
    widths = np.asarray(da.layout.widths, np.int64)[None, :]
    n_out = np.minimum(nsym, widths)
    rans_ops = RANS_OPS_PER_LANE_STEP * int((-(-n_out // lanes) * lanes).sum())

    # the chunk's largest depth bucket, at that bucket's rounds
    groups = d._ra_groups(sel_np) or [(da.max_depth, np.arange(CHUNK))]
    rounds, idx = max(groups, key=lambda g: g[1].size)
    gsel = torch.from_numpy(sel_np[idx]).to(d.device)
    m = dec._match_inputs(da, dec._entropy_decode_sel(da, gsel), gsel)
    got = ops.lz77_decode_planes(**m, n_rounds=rounds)
    lz_err = max_abs_err(got, ref.lz77_decode_planes_ref(**m,
                                                         n_rounds=rounds))
    lz_ms = kernel_ms(lambda: ops.lz77_decode_planes(**m, n_rounds=rounds),
                      "lz77_match_kernel", 20)
    # prologue, fill and payout alone: the same launch with no rounds
    lz_ms_0_rounds = kernel_ms(
        lambda: ops.lz77_decode_planes(**m, n_rounds=0),
        "lz77_match_kernel", 5)
    lz_call_ms = time_ms(
        lambda: ops.lz77_decode_planes(**m, n_rounds=rounds), 20)
    lz_plain_ms = time_ms(
        lambda: ref.lz77_decode_planes_ref(**m, n_rounds=rounds), 2)
    B = got.shape[0]
    nc = a.n_cmds[sel_np[idx]].astype(np.int64)
    lz_bytes = ((4 + da.offset_bytes) * int(nc.sum())      # command planes
                + int(a.n_syms[sel_np[idx], S_LITERALS].sum())  # literals
                + 2 * B * 4 + got.numel())                 # table, output
    lz_ops = LZ77_OPS_PER_BYTE * got.numel()
    depth = a.block_depth[sel_np[idx]].astype(np.int64)
    lz_kernel_ops = da.block_size * int(
        (LZ77_KERNEL_OPS_PER_BYTE
         + LZ77_KERNEL_OPS_PER_BYTE_ROUND * depth).sum())
    occ = ops.lz77_occupancy(da.block_size, da.max_cmds, DEVICE)

    def bound(n_bytes, n_ops):
        b_ms, o_ms = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_OPS * 1e3
        return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"

    out = {}
    for name, ms, call_ms, plain_ms, err, nb, no, shape in (
            ("rans_decode", rans_ms, rans_call_ms, rans_plain_ms, rans_err,
             rans_bytes, rans_ops, {"blocks": CHUNK, "streams": S,
                                    "row_bytes": da.layout.row,
                                    "ms_by_group": rans_ms_by_group}),
            ("lz77_match", lz_ms, lz_call_ms, lz_plain_ms, lz_err, lz_bytes,
             lz_ops, {"blocks": B, "max_cmds": da.max_cmds,
                      "n_rounds": rounds, "ms_at_0_rounds": lz_ms_0_rounds,
                      "kernel_ops_ms": lz_kernel_ops / PEAK_OPS * 1e3,
                      "config": occ})):
        b_ms, by = bound(nb, no)
        out[name] = {"ms": ms, "wrapper_call_ms": call_ms,
                     "plain_ms": plain_ms, "max_abs_err": err,
                     "bound_ms": b_ms, "bound_by": by, "bytes": nb,
                     "ops": no, "bytes_ms": nb / PEAK_BYTES * 1e3,
                     "ops_ms": no / PEAK_OPS * 1e3, "library_ms": None,
                     **shape}
    emit({"phase": "timing", "chunk_blocks": CHUNK, **out})
    if rans_err or lz_err:
        fail("a kernel differs from its plain version at main-path shapes")
    return out


def phase_profile(store, a):
    """Device busy time and idle share of one decode chunk, one B=256
    fetch and one parity XOR rebuild (a 16 KiB block of an 8-block group
    of the 16 MiB archive `a` with its parity tail, on the card), and
    every kernel that ran on the device: launches and device ms by
    name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.decoder import Decoder
    from repro_torch.resilience.parity import reconstruct_blocks, with_parity
    rng = np.random.default_rng(SEED + 1)
    d = store.decoder
    ids = rng.integers(0, store.index.n_reads, 256)
    pd = Decoder(with_parity(a, HEAL_GROUP), device=DEVICE)
    words0 = pd.da.words.clone()
    b = a.n_blocks // 2 + 3
    result = {}
    for name, fn in (
            ("decode_chunk", lambda: d.decode_blocks(np.arange(CHUNK))),
            ("fetch_b256", lambda: store.fetch_reads(ids)),
            ("xor_rebuild", lambda: reconstruct_blocks(pd, [b]))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_prof_ms = (time.perf_counter() - t0) * 1e3
        kernels = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n, ms = kernels.get(e.name, (0, 0.0))
                kernels[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
        busy = sum(ms for _, ms in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
        result[name] = {"wall_ms": wall_ms, "wall_ms_profiled": wall_prof_ms,
                        "device_busy_ms": busy,
                        "idle_share_profiled": 1 - busy / wall_prof_ms,
                        "device_launches": sum(n for n, _ in
                                               kernels.values()),
                        "launches_ms_by_kernel": [[k[:90], n, ms] for
                                                  k, (n, ms) in top]}
    emit({"phase": "profile", **result})
    if not torch.equal(pd.da.words, words0):
        fail("rebuilding a clean block changed its words")
    return result


def _peak_above(base: int) -> int:
    import torch
    sync()
    return torch.cuda.max_memory_allocated() - base


def _reset_peak() -> int:
    """Reset the peak counter; the bytes allocated now are the base."""
    import torch
    sync()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _window_profile(dec, firsts) -> dict:
    """Device time of anchor-window decodes by the profiler, split into
    the rANS kernel and everything else (the plain-PyTorch resolve and
    its glue)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run():
        for f in firsts:
            dec.decode_from_anchor(f, f + ANCHOR - 1)
        sync()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    rans_ms = other_ms = 0.0
    launches = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            launches += 1
            if "rans_decode_kernel" in e.name:
                rans_ms += ms
            else:
                other_ms += ms
    w = len(firsts)
    return {"windows": w, "blocks_per_window": ANCHOR,
            "wall_ms_per_window": wall_ms / w,
            "device_ms_per_window": (rans_ms + other_ms) / w,
            "rans_decode_ms_per_window": rans_ms / w,
            "resolve_ms_per_window": other_ms / w,
            "resolve_share_of_device": other_ms / max(rans_ms + other_ms,
                                                      1e-9),
            "device_launches_per_window": launches / w}


def phase_global():
    """Global (wavefront) archives through the query plane: a 64 MiB
    anchored archive behind `GenomicArchive` (decode_all, windows,
    mixed queries, cache co-install, stream), a 16 MiB anchor-free one
    and 1 MiB placed across 2^32."""
    import torch
    from repro_torch.api import ByteRange, GenomicArchive, ReadId, Region
    from repro_torch.api.executors import StreamingExecutor
    from repro_torch.core.decoder import Decoder
    from repro_torch.core.encoder import encode
    from repro_torch.core.index import parse_fastq_records
    from repro_torch.data.tiling import aligned_fastq
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED + 2)
    corpus = aligned_fastq(GLOBAL_BLOCKS, BLOCK, seed=SEED + 2)
    src = np.frombuffer(corpus, np.uint8)
    starts, names = parse_fastq_records(corpus)
    starts = starts.astype(np.int64)
    t0 = time.perf_counter()
    ga = GenomicArchive.from_bytes(corpus, block_size=BLOCK, mode="global",
                                   anchor_interval=ANCHOR,
                                   cache_blocks=256, device=DEVICE)
    build_s = time.perf_counter() - t0
    d = ga.store.decoder
    a = d.archive
    ops.reset_launches()
    # a window miss co-installs its siblings: the next sibling is a hit
    w0 = 8 * ANCHOR
    lo = (w0 + ANCHOR - 1) * BLOCK
    got = ga[lo:lo + 100]
    info0 = ga.cache_info()
    sib = [ga[(w0 + i) * BLOCK + 5:(w0 + i) * BLOCK + 105]
           for i in range(ANCHOR - 1)]
    info1 = ga.cache_info()
    if (info0["coinstalls"] != ANCHOR - 1
            or info1["decode_launches"] != info0["decode_launches"]
            or info1["hits"] - info0["hits"] != ANCHOR - 1
            or got.tobytes() != corpus[lo:lo + 100]
            or any(x.tobytes() != corpus[(w0 + i) * BLOCK + 5:
                                         (w0 + i) * BLOCK + 105]
                   for i, x in enumerate(sib))):
        fail(f"window co-install: {info0} then {info1}")
    t0 = time.perf_counter()
    out = d.decode_all(chunk_blocks=CHUNK)
    decode_all_s = time.perf_counter() - t0
    if out.tobytes() != corpus:
        fail("global decode_all is not bit-perfect")
    del out
    # random block ranges from their anchors: windows, never the prefix
    worst = 0
    t0 = time.perf_counter()
    for _ in range(256):
        first = int(rng.integers(0, a.n_blocks))
        last = min(a.n_blocks - 1, first + int(rng.integers(0, 4)))
        rows = d.decode_from_anchor(first, last)
        span = last - first + 1
        if d.decoded_blocks_last > ANCHOR + span:
            fail(f"decode_from_anchor({first}, {last}) decoded "
                 f"{d.decoded_blocks_last} blocks")
        worst = max(worst, d.decoded_blocks_last - span)
        if rows.cpu().numpy().tobytes() != corpus[first * BLOCK:
                                                  (last + 1) * BLOCK]:
            fail(f"decode_from_anchor({first}, {last}) is not the source")
    ranges_s = time.perf_counter() - t0
    # 256 mixed addresses: read ids, named regions (one across a block
    # edge), byte ranges
    n_reads = starts.size - 1
    cut_at = (starts[:-1] // BLOCK + 1) * BLOCK - starts[:-1]
    cross = int(np.flatnonzero((cut_at >= 7)
                               & (cut_at + 9 <= np.diff(starts)))[0])
    cut = int(cut_at[cross])
    addrs, want = [Region(names[cross], int(cut) - 7, int(cut) + 9)], [
        corpus[starts[cross] + cut - 7:starts[cross] + cut + 9]]
    for i in range(255):
        r = int(rng.integers(0, n_reads))
        s, e = int(starts[r]), int(starts[r + 1])
        if i % 3 == 0:
            addrs.append(ReadId(r))
            want.append(corpus[s:e])
        elif i % 3 == 1:
            addrs.append(names[r].decode("latin-1") + ":3-40")
            want.append(corpus[s + 2:s + 40])
        else:
            lo = int(rng.integers(0, len(corpus) - 3000))
            hi = lo + int(rng.integers(1, 3000))
            addrs.append(ByteRange(lo, hi))
            want.append(corpus[lo:hi])
    t0 = time.perf_counter()
    rows_l = [ga.query(addrs[i:i + 64]) for i in range(0, 256, 64)]
    sync()
    query_s = time.perf_counter() - t0
    for q, (rows, lens) in enumerate(rows_l):
        rows, lens = rows.cpu().numpy(), lens.cpu().numpy()
        for i in range(rows.shape[0]):
            if rows[i, :lens[i]].tobytes() != want[64 * q + i]:
                fail(f"global query {addrs[64 * q + i]} is not the source")
    # a stream under four windows of budget
    budget = 4 * (ANCHOR + 1) * BLOCK
    ex = StreamingExecutor(ga.store, max_resident_bytes=budget,
                           planner=ga.planner)
    t0 = time.perf_counter()
    got = np.concatenate(list(ex.chunks([ByteRange(0, 16 << 20)])))
    stream_s = time.perf_counter() - t0
    if got.tobytes() != corpus[:16 << 20] or any(
            c.resident_bytes > budget for c in ex.chunk_log):
        fail("global stream under budget failed")
    profile = _window_profile(d, np.arange(0, 32 * ANCHOR, ANCHOR) + 400)
    anchored = {"corpus_bytes": len(corpus), "build_s": build_s,
                "n_blocks": a.n_blocks, "max_depth": a.max_depth,
                "compressed_device_bytes": ga.stats().compressed_device_bytes,
                "decode_all_s": decode_all_s,
                "decode_all_GBps": len(corpus) / decode_all_s / 1e9,
                "ranges": 256, "ranges_s": ranges_s,
                "worst_extra_blocks": worst, "queries": 256,
                "query_s": query_s, "stream_budget": budget,
                "stream_chunks": len(ex.chunk_log), "stream_s": stream_s,
                "cache_after_coinstall": info1, "window_profile": profile}
    # 16 MiB anchor-free: every decode is the whole prefix
    corpus = aligned_fastq(FREE_BLOCKS, BLOCK, seed=SEED + 3)
    t0 = time.perf_counter()
    a = encode(corpus, block_size=BLOCK, mode="global")
    encode_s = time.perf_counter() - t0
    d = Decoder(a, device=DEVICE)
    base = _reset_peak()
    t0 = time.perf_counter()
    out = d.decode_all()
    free_s = time.perf_counter() - t0
    peak = _peak_above(base)
    if out.tobytes() != corpus:
        fail("anchor-free global decode_all is not bit-perfect")
    sel = rng.integers(0, a.n_blocks, 8)
    rows = d.decode_blocks(sel).cpu().numpy()
    if d.decoded_blocks_last != a.n_blocks or any(
            rows[i].tobytes() != corpus[b * BLOCK:(b + 1) * BLOCK]
            for i, b in enumerate(sel)):
        fail("anchor-free decode_blocks")
    # a quarter-size anchor-free archive: the resolve's peak at two window
    # sizes gives its bytes per window byte and what stays fixed
    small = aligned_fastq(FREE_BLOCKS // 4, BLOCK, seed=SEED + 5)
    ds = Decoder(encode(small, block_size=BLOCK, mode="global"),
                 device=DEVICE)
    base = _reset_peak()
    if ds.decode_all().tobytes() != small:
        fail("the small anchor-free archive does not decode to its source")
    peak_small = _peak_above(base)
    slope = (peak - peak_small) / (len(corpus) - len(small))
    fixed = peak - slope * len(corpus)
    resident = ds.da.device_bytes / len(small)
    del ds
    free = {"corpus_bytes": len(corpus), "encode_s": encode_s,
            "decode_all_s": free_s, "max_depth": a.max_depth,
            "decoded_blocks_last": d.decoded_blocks_last,
            "peak_device_bytes_above_resident": peak,
            "peak_bytes_per_window_byte": peak / len(corpus),
            "peak_bytes_by_window": {len(small): peak_small,
                                     len(corpus): peak},
            "resolve_bytes_per_window_byte": slope,
            "resolve_fixed_bytes": fixed,
            "resident_bytes_per_raw_byte": resident,
            # the largest anchor-free archive whose residency and
            # whole-prefix resolve fit the card's memory on that line
            "largest_decodable_bytes": (
                (torch.cuda.get_device_properties(0).total_memory - fixed)
                / (slope + resident) if DEVICE == "cuda" and slope > 0
                else None)}
    del d, out
    # 1 MiB across 2^32: the window rebase wraps on the card
    corpus = aligned_fastq(WRAP_BLOCKS, BLOCK, seed=SEED + 4)
    a = encode(corpus, block_size=BLOCK, mode="global",
               anchor_interval=ANCHOR, origin=WRAP_ORIGIN)
    d = Decoder(a, device=DEVICE)
    sel = np.array([0, WRAP_BLOCKS // 2 - 1, WRAP_BLOCKS // 2,
                    WRAP_BLOCKS - 1])
    rows = d.decode_blocks(sel).cpu().numpy()
    if d.decode_all().tobytes() != corpus or any(
            rows[i].tobytes() != corpus[b * BLOCK:(b + 1) * BLOCK]
            for i, b in enumerate(sel)):
        fail("the archive across 2^32 does not decode to its source")
    wrap = {"origin": WRAP_ORIGIN, "bytes": len(corpus),
            "block_start_low32_wraps": bool(
                (a.block_start[0] >> 32) != (a.block_start[-1] >> 32)),
            "bit_perfect": True}
    launches = dict(ops.LAUNCHES)
    emit({"phase": "global", "anchored": anchored, "anchor_free": free,
          "across_2_32": wrap, "launches": launches})
    return launches, profile


def phase_mode1(corpus, index, store):
    """Mode 1 on the 8 GiB "ra" store: host rANS, device match."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED + 5)
    starts = np.asarray(index.starts, np.int64)
    n_reads = store.index.n_reads
    ops.reset_launches()
    t0 = time.perf_counter()
    batches = []
    for _ in range(10):
        ids = rng.integers(0, n_reads, 256)
        batches.append((*store.fetch_reads(ids, mode2=False), ids))
    sync()
    fetch_s = time.perf_counter() - t0
    for out, lens, ids in batches:
        _check_reads(out, lens, ids, corpus, starts)
    lo = (store.decoder.da.n_blocks // 3) * BLOCK
    t0 = time.perf_counter()
    got = store.decoder.decode_range(lo, lo + (64 << 20), mode2=False)
    range_s = time.perf_counter() - t0
    check_tiled(got, lo, np.frombuffer(corpus, np.uint8),
                "Mode 1 decode_range")
    launches = dict(ops.LAUNCHES)
    emit({"phase": "mode1", "b256_batches": 10, "fetch_s": fetch_s,
          "reads_per_s": 2560 / fetch_s, "range_bytes": got.size,
          "range_s": range_s, "range_GBps": got.size / range_s / 1e9,
          "launches": launches})
    if not launches["lz77_match"] or launches["rans_decode"]:
        fail(f"Mode 1 launches: {launches}")
    return launches


def phase_stream(corpus, store):
    """`GenomicArchive.stream` over 1 GiB and all 8 GiB under one budget:
    the peak above residency must not grow with the output."""
    from repro_torch.api import ByteRange, GenomicArchive
    from repro_torch.kernels import ops
    ga = GenomicArchive(store)
    src = np.frombuffer(corpus, np.uint8)
    runs = []
    ops.reset_launches()
    for hi in (1 << 30, ga.raw_size):
        base = _reset_peak()
        pos = 0
        chunks = 0
        t0 = time.perf_counter()
        for chunk in ga.stream([ByteRange(0, hi)],
                               max_resident_bytes=STREAM_BUDGET):
            check_tiled(chunk, pos, src, "stream")
            pos += chunk.size
            chunks += 1
        stream_s = time.perf_counter() - t0
        if pos != hi:
            fail(f"stream yielded {pos} of {hi} bytes")
        runs.append({"bytes": hi, "chunks": chunks, "s": stream_s,
                     "GBps": hi / stream_s / 1e9,
                     "peak_device_bytes_above_resident": _peak_above(base)})
    launches = dict(ops.LAUNCHES)
    ratio = (runs[1]["peak_device_bytes_above_resident"]
             / runs[0]["peak_device_bytes_above_resident"])
    emit({"phase": "stream", "max_resident_bytes": STREAM_BUDGET,
          "runs": runs, "peak_ratio_8GiB_over_1GiB": ratio,
          "launches": launches})
    if ratio > 1.10:
        fail(f"the 8 GiB stream peaks {ratio:.3f}x the 1 GiB stream")
    return launches


def phase_cache(corpus, index, tiled):
    """A store with 8192 cached blocks under Zipf(1.1) batches of 256 read
    ids: 64 batches from cold, then batches until the cache is full and
    evicting, then 64 batches at steady state."""
    from repro_torch.core.residency import CompressedResidentStore
    from repro_torch.data.tiling import tile_index
    from repro_torch.kernels import ops
    store = CompressedResidentStore(
        tiled, tile_index(index, TILES, len(corpus)), device=DEVICE,
        cache_blocks=CACHE_BLOCKS)
    rng = np.random.default_rng(SEED + 6)
    n_reads = store.index.n_reads
    cdf = np.cumsum(1.0 / np.arange(1, n_reads + 1) ** 1.1)
    cdf /= cdf[-1]
    perm = rng.permutation(n_reads)
    starts = np.asarray(index.starts, np.int64)

    def batch():
        return perm[np.minimum(np.searchsorted(cdf, rng.random(256)),
                               n_reads - 1)]

    def run(batches):
        """Fetch each batch, check its bytes, and read the counters."""
        info0 = store.cache_info()
        ops.reset_launches()
        buckets, got = [], []
        sync()
        t0 = time.perf_counter()
        for ids in batches:
            calls = store.cache_info()["decode_launches"]
            got.append((*store.fetch_reads(ids), ids))
            if store.cache_info()["decode_launches"] > calls:
                buckets.append(len(store.decoder.launch_rounds_last))
        sync()
        run_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        for out, lens, ids in got:
            _check_reads(out, lens, ids, corpus, starts)
        info = store.cache_info()
        hits = info["hits"] - info0["hits"]
        misses = info["misses"] - info0["misses"]
        n = len(batches)
        return launches, {
            "batches": n, "hit_rate": hits / (hits + misses),
            "reads_per_s": n * 256 / run_s, "ms_per_batch": run_s * 1e3 / n,
            "evictions": info["evictions"] - info0["evictions"],
            "decode_calls": (info["decode_launches"]
                             - info0["decode_launches"]),
            "launches_per_batch": {k: v / n for k, v in launches.items()},
            "depth_buckets_per_miss_decode": (float(np.mean(buckets))
                                              if buckets else 0.0),
            "cache_info": info}

    store.fetch_reads(batch()[:8])           # warm-up
    launches, cold = run([batch() for _ in range(64)])
    fill = 0
    while store.cache_info()["evictions"] == 0:
        if fill == 1024:
            fail(f"the cache never evicted: {store.cache_info()}")
        store.fetch_reads(batch())
        fill += 1
    steady_launches, steady = run([batch() for _ in range(64)])
    if not steady["evictions"]:
        fail(f"the steady-state cache run evicted nothing: {steady}")
    for k, v in steady_launches.items():
        launches[k] += v
    emit({"phase": "cache", "capacity": CACHE_BLOCKS, "batch": 256,
          "zipf_s": 1.1, "cold": cold, "batches_to_first_eviction": fill,
          "steady": steady, "launches": launches})
    return launches


def _reads_of_blocks(starts: np.ndarray, blocks) -> np.ndarray:
    """Read ids of the tiled store (start table `starts`, i64) whose bytes
    overlap any of `blocks`."""
    ids = []
    for b in np.asarray(blocks, np.int64):
        lo = int(np.searchsorted(starts, b * BLOCK, "right")) - 1
        hi = int(np.searchsorted(starts, (b + 1) * BLOCK, "left"))
        ids.extend(range(max(lo, 0), min(hi, starts.size - 1)))
    return np.unique(np.asarray(ids, np.int64))


def phase_heal(corpus, index, a):
    """The 16 MiB archive with an XOR-parity tail of 8-block groups,
    tiled to an 8 GiB store (on_error="repair" by default). One payload
    word flipped in each of 64 groups spread over the store, then: the
    verified decode_all (with and without the 64 heals, in turns), a
    cached fetch_reads over freshly flipped blocks, and a stream over a
    freshly flipped range — each bit-perfect."""
    import torch
    from repro_torch.api import ByteRange, GenomicArchive
    from repro_torch.core.residency import CompressedResidentStore
    from repro_torch.data.tiling import tile_archive, tile_index
    from repro_torch.kernels import ops
    from repro_torch.resilience.faults import FaultInjector
    from repro_torch.resilience.parity import reconstruct_blocks, with_parity
    src = np.frombuffer(corpus, np.uint8)
    t0 = time.perf_counter()
    pa = tile_archive(with_parity(a, HEAL_GROUP), TILES)
    store = CompressedResidentStore(
        pa, tile_index(index, TILES, len(corpus)), device=DEVICE,
        cache_blocks=HEAL_CACHE, verify=True, on_error="repair")
    sync()
    build_s = time.perf_counter() - t0
    dec = store.decoder
    starts = np.asarray(store.index.starts, np.int64)
    n_groups = pa.n_blocks // HEAL_GROUP
    fi = FaultInjector(seed=SEED + 7)
    rng = np.random.default_rng(SEED + 7)

    def flip_groups(offset: int) -> np.ndarray:
        """One word flipped in each of HEAL_FLIPS groups spread evenly
        over the store; returns the flipped blocks."""
        groups = (np.arange(HEAL_FLIPS) * (n_groups // HEAL_FLIPS)
                  + offset) % n_groups
        blocks = groups * HEAL_GROUP + rng.integers(0, HEAL_GROUP,
                                                    HEAL_FLIPS)
        for b in blocks:
            fi.flip_payload_word(dec, block=int(b))
        return blocks

    def verified_all(what: str) -> float:
        info0 = dec.recover_info()
        t0 = time.perf_counter()
        out = dec.decode_all(chunk_blocks=HEAL_CHUNK, verify=True,
                             on_error="repair")
        s = time.perf_counter() - t0
        check_all(out, src, what)
        info = dec.recover_info()
        return s, {k: info[k] - info0[k] for k in info}

    # one XOR rebuild alone, on the clean store: it rewrites the same
    # words (its device time is the profile phase's)
    b = pa.n_blocks // 2 + 3
    w0, w1 = int(pa.word_off[b, 0]), int(pa.word_off[b + 1, 0])
    words0 = dec.da.words[w0:w1].clone()
    sync()
    t0 = time.perf_counter()
    reconstruct_blocks(dec, [b])
    sync()
    xor_wall_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(dec.da.words[w0:w1], words0):
        fail("rebuilding a clean block changed its words")
    ops.reset_launches()
    turns = []
    clean_s, d = verified_all("the clean verified decode_all")
    turns.append(["clean", clean_s, d])
    failed_first = []
    for offset in (0, 1):
        flip_groups(offset)
        heal_s, d = verified_all("the healing decode_all")
        turns.append(["heal", heal_s, d])
        failed_first.append(d["reconstructed"] + d["unrecoverable"])
        if d["unrecoverable"] or not d["reconstructed"]:
            fail(f"64 flips in 64 groups healed as {d}")
    clean_s, d = verified_all("the clean verified decode_all")
    turns.append(["clean", clean_s, d])
    decode_launches = dict(ops.LAUNCHES)
    # a cached fetch over freshly flipped blocks, then again from the cache
    flipped = flip_groups(2)
    ids = _reads_of_blocks(starts, flipped)
    info0 = dec.recover_info()
    t0 = time.perf_counter()
    for _ in range(2):
        out, lens = store.fetch_reads(ids)
        _check_reads(out, lens, ids, corpus, np.asarray(index.starts,
                                                        np.int64))
    fetch_s = time.perf_counter() - t0
    fetch_healed = dec.recover_info()["reconstructed"] - \
        info0["reconstructed"]
    if not fetch_healed:
        fail("the cached fetch over flipped blocks healed nothing")
    # a stream over a freshly flipped range of 64 blocks
    lo = pa.n_blocks // 3 // HEAL_GROUP * HEAL_GROUP
    for b in (lo + 3, lo + 20, lo + 45):
        fi.flip_payload_word(dec, block=b)
    info0 = dec.recover_info()
    pos = lo * BLOCK
    for chunk in GenomicArchive(store).stream(
            [ByteRange(lo * BLOCK, (lo + 64) * BLOCK)],
            max_resident_bytes=16 * BLOCK, verify=True, on_error="repair"):
        check_tiled(chunk, pos, src, "the healing stream")
        pos += chunk.size
    if pos != (lo + 64) * BLOCK:
        fail("the healing stream ended early")
    stream_healed = dec.recover_info()["reconstructed"] - \
        info0["reconstructed"]
    launches = dict(ops.LAUNCHES)
    emit({"phase": "heal", "raw_bytes": pa.raw_size, "n_blocks": pa.n_blocks,
          "parity_group": HEAL_GROUP, "parity_groups": n_groups,
          "parity_bytes": int(pa.parity_words.size) * 2,
          "compressed_device_bytes": store.stats().compressed_device_bytes,
          "build_s": build_s, "flips_per_heal_run": HEAL_FLIPS,
          "verified_chunk_blocks": HEAL_CHUNK,
          "decode_all_turns": turns,
          "failed_first_verification": failed_first,
          "extra_s_per_heal_run": (
              (turns[1][1] + turns[2][1] - turns[0][1] - turns[3][1]) / 2),
          "fetch_reads": int(ids.size), "fetch_s": fetch_s,
          "fetch_healed": fetch_healed, "stream_healed": stream_healed,
          "recover_info": dec.recover_info(),
          "xor_rebuild": {"block_words": w1 - w0,
                          "siblings": HEAL_GROUP - 1,
                          "wall_ms": xor_wall_ms},
          "decode_all_launches": decode_launches, "launches": launches,
          "bit_perfect": True})
    return launches, store, xor_wall_ms


def phase_partial(corpus, index, store):
    """Two flips in one parity group of the heal store, served through a
    `ServingFrontend(verify=True, on_error="partial")`: the reads of the
    two blocks come back as typed `ReadCorrupt`, every other read is
    bit-exact, the blocks quarantine and never decode again, a repair
    decode of them raises; a corrupted digest table stays fatal and a
    transient fault retries bit-exact."""
    from repro_torch.api import GenomicArchive
    from repro_torch.core.decoder import BlockDigestError
    from repro_torch.kernels import ops
    from repro_torch.resilience.faults import (FaultInjector,
                                               TransientDecodeError)
    from repro_torch.serving.frontend import ReadCorrupt, ServingFrontend
    dec = store.decoder
    src = np.frombuffer(corpus, np.uint8)
    starts = np.asarray(store.index.starts, np.int64)
    g = dec.da.n_blocks // HEAL_GROUP * 2 // 3
    blks = [g * HEAL_GROUP + 1, g * HEAL_GROUP + 5]
    hit = _reads_of_blocks(starts, blks)
    rng = np.random.default_rng(SEED + 8)
    ids = np.unique(np.concatenate([
        _reads_of_blocks(starts, range(g * HEAL_GROUP,
                                       (g + 1) * HEAL_GROUP)),
        rng.integers(0, starts.size - 1, 256)]))
    fi = FaultInjector(seed=SEED + 8)
    fe = ServingFrontend({"wgs": GenomicArchive(store)}, verify=True,
                         on_error="partial")
    fe.register_tenant("clinical", "wgs")
    ops.reset_launches()
    t0 = time.perf_counter()
    for trial in range(5):
        for b in blks:
            fi.flip_payload_word(dec, block=b)
        store._cache.invalidate(np.asarray(blks, np.int64))
        tickets = [fe.submit("clinical", int(i)) for i in ids]
        fe.drain()
        res = [fe.result(t) for t in tickets]
        if any(r.status == "corrupt" for r in res):
            break
    else:
        fail("two flips in one parity group were never detected")
    serve_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    n_reads = index.n_reads
    istarts = np.asarray(index.starts, np.int64)
    corrupt = []
    for r, i in zip(res, ids):
        if r.status == "corrupt":
            if not isinstance(r.payload, ReadCorrupt) or i not in hit:
                fail(f"read {i} reported corrupt: {r}")
            corrupt.append(int(i))
            continue
        s, e = int(istarts[i % n_reads]), int(istarts[i % n_reads + 1])
        if r.status != "ok" or r.payload.tobytes() != corpus[s:e]:
            fail(f"healthy read {i} disturbed: {r.status}")
    info = dec.recover_info()
    q = sorted(dec.quarantined)
    if not q or not set(q) <= set(blks):
        fail(f"quarantine {q} after flipping {blks}")
    # the quarantined blocks never decode again: no launch, zero rows
    before = dict(ops.LAUNCHES)
    dec.decoded_blocks_last = 0
    rows = dec.decode_blocks(q, verify=True, on_error="partial")
    if (dec.decoded_blocks_last or bool(rows.any())
            or dict(ops.LAUNCHES) != before):
        fail("a quarantined block was decoded again")
    try:
        dec.decode_blocks(q, verify=True, on_error="repair")
        fail("a repair decode of quarantined blocks did not raise")
    except BlockDigestError as e:
        if "quarantined" not in str(e):
            raise
    # the digest table stays fatal under every on_error
    ev = fi.corrupt_digest(dec, block=int(blks[0]) + 1)
    for how in ("raise", "repair", "partial"):
        try:
            dec.decode_all(chunk_blocks=HEAL_CHUNK, verify=True,
                           on_error=how)
            fail(f"a corrupt digest table decoded under {how}")
        except BlockDigestError as e:
            if "file digest" not in str(e):
                raise
    dec.archive.block_fnv[ev["block"]] ^= np.uint64(1 << ev["bit"])
    # a transient fault fails one call; the retry is bit-exact
    fi.transient_failures(dec, n=1)
    lo = dec.da.n_blocks // 4
    sel = np.arange(lo, lo + min(256, lo))
    try:
        dec.decode_blocks(sel, verify=True)
        fail("the injected transient fault did not raise")
    except TransientDecodeError:
        pass
    rows = dec.decode_blocks(sel, verify=True).cpu().numpy()
    per_tile = len(corpus) // BLOCK
    want = src.reshape(per_tile, BLOCK)[sel % per_tile]
    if not np.array_equal(rows, want):
        fail("the retry after a transient fault is not the source")
    emit({"phase": "partial", "group": g, "flipped_blocks": blks,
          "trials": trial + 1, "reads": int(ids.size),
          "reads_of_flipped_blocks": int(hit.size),
          "corrupt_results": len(corrupt), "serve_s": serve_s,
          "quarantined": q, "recover_info": info,
          "tenant": fe.stats()["tenants"]["clinical"],
          "digest_table_fatal": True, "transient_retry_bit_exact": True,
          "launches": launches})
    if not launches["rans_decode"] or not launches["lz77_match"]:
        fail(f"partial serving launches: {launches}")
    return launches


def phase_serve(corpus, index, tiled):
    """A `ServingFrontend` over the 8 GiB store as a `GenomicArchive`: a
    cache of CACHE_BLOCKS slots under `TenantPartitionPolicy` (a floor of
    SERVE_FLOOR each), a priority-0 tenant of Zipf(1.1) read ids with a
    tight deadline and a priority-2 tenant mixing Zipf read ids and byte
    spans, closed loop; then a burst against a small queue. Every served
    payload is checked against the source."""
    from repro_torch.api import GenomicArchive
    from repro_torch.api.cache import FrequencySketch
    from repro_torch.core.residency import CompressedResidentStore
    from repro_torch.data.tiling import tile_index
    from repro_torch.kernels import ops
    from repro_torch.serving.admission import TenantPartitionPolicy
    from repro_torch.serving.frontend import ServingFrontend, Ticket
    from repro_torch.serving.traffic import (MixSampler, ScanSampler,
                                             TenantLoad, ZipfianSampler,
                                             run_closed_loop)
    src = np.frombuffer(corpus, np.uint8)
    istarts = np.asarray(index.starts, np.int64)
    pol = TenantPartitionPolicy({"clinical": SERVE_FLOOR,
                                 "cohort": SERVE_FLOOR})
    store = CompressedResidentStore(
        tiled, tile_index(index, TILES, len(corpus)), device=DEVICE,
        cache_blocks=CACHE_BLOCKS, cache_policy=pol)
    ga = GenomicArchive(store)
    keys = min(SERVE_KEYS, ga.n_reads)
    stride = ga.n_reads // keys

    class Spread:
        """Zipf keys spread over every read id of the store."""

        def __init__(self, seed):
            self.z = ZipfianSampler(keys, s=1.1, seed=seed)

        def draw(self, k):
            return [i * stride for i in self.z.draw(k)]

    class Checked(ServingFrontend):
        """Keeps every served payload with its address, and the decode
        calls of each dispatch."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.addr, self.served = {}, []
            self.dispatches = self.max_decodes = 0
            self.dispatch_s = {}

        def submit(self, tenant, address, **kw):
            t = super().submit(tenant, address, **kw)
            if isinstance(t, Ticket):
                self.addr[t.seq] = address
            return t

        def _dispatch(self, akey, tenant, reqs):
            calls = ga.cache_info()["decode_launches"]
            t0 = time.perf_counter()
            out = super()._dispatch(akey, tenant, reqs)
            self.dispatch_s[tenant] = (self.dispatch_s.get(tenant, 0.0)
                                       + time.perf_counter() - t0)
            self.dispatches += 1
            self.max_decodes = max(
                self.max_decodes, ga.cache_info()["decode_launches"] - calls)
            return out

        def take_results(self):
            out = super().take_results()
            for seq, res in out.items():
                if res.payload is not None:
                    self.served.append((self.addr[seq], res.payload))
            return out

    def check(fe):
        for addr, payload in fe.served:
            if isinstance(addr, slice):
                if payload.size != addr.stop - addr.start:
                    fail(f"span {addr} served {payload.size} bytes")
                check_tiled(payload, addr.start, src, "a served span")
            else:
                r = addr % index.n_reads
                if payload.tobytes() != corpus[istarts[r]:istarts[r + 1]]:
                    fail(f"served read {addr} is not the source")
        return len(fe.served)

    def report(fe, rep, info0):
        b = fe._batchers.get("wgs")
        flushes = b.stats()["flushes"] if b else 0
        st = fe.stats()
        el = rep["aggregate"]["elapsed_s"]
        return {"elapsed_s": el, "steps": st["steps"],
                "device_bytes": st["device_bytes"], "flushes": flushes,
                "dispatches": fe.dispatches,
                "dispatch_s_by_tenant": fe.dispatch_s,
                "max_decode_calls_per_dispatch": fe.max_decodes,
                "decode_calls": (ga.cache_info()["decode_launches"]
                                 - info0["decode_launches"]),
                "payloads_checked": check(fe),
                "estimator": rep["estimator"],
                "tenants": {name: {**t, "reads_per_s": (t["ok"] + t["late"])
                                   / el,
                                   "partition_slots":
                                       pol.resident_counts().get(name, 0)}
                            for name, t in rep["tenants"].items()}}

    fe = Checked({"wgs": ga}, max_batch=256)
    fe.register_tenant("clinical", "wgs", priority=0)
    fe.register_tenant("cohort", "wgs", priority=2)
    loads = [
        TenantLoad("clinical", Spread(SEED + 9), requests=SERVE_REQUESTS,
                   concurrency=SERVE_CONCURRENCY,
                   deadline_us=SERVE_DEADLINE_US),
        TenantLoad("cohort", MixSampler(
            [Spread(SEED + 10), ScanSampler(ga.raw_size, span_bytes=4 * BLOCK,
                                            seed=SEED + 11)],
            [0.7, 0.3], seed=SEED + 12), requests=SERVE_REQUESTS,
            concurrency=SERVE_CONCURRENCY, deadline_us=1e6),
    ]
    ops.reset_launches()
    info0 = ga.cache_info()
    rep = run_closed_loop(fe, loads, verify_sample=8)
    loop = report(fe, rep, info0)
    if fe.max_decodes > 1:
        fail(f"a dispatch made {fe.max_decodes} decode calls")
    # a burst: the low band's small queue pushes back, the high band is
    # served in full
    burst = Checked({"wgs": ga}, max_batch=256)
    burst.register_tenant("hi", "wgs", priority=0, max_queue=256)
    burst.register_tenant("lo", "wgs", priority=2,
                          max_queue=SERVE_CONCURRENCY // 2)
    info1 = ga.cache_info()
    n_hi = SERVE_REQUESTS // 4
    brep = run_closed_loop(burst, [
        TenantLoad("hi", Spread(SEED + 13), requests=n_hi,
                   concurrency=2 * SERVE_CONCURRENCY),
        TenantLoad("lo", Spread(SEED + 14), requests=SERVE_REQUESTS // 2,
                   concurrency=4 * SERVE_CONCURRENCY)], verify_sample=0)
    launches = dict(ops.LAUNCHES)
    hi, lo = brep["tenants"]["hi"], brep["tenants"]["lo"]
    if hi["ok"] != n_hi or hi["rejected"] or hi["shed"] or hi["late"]:
        fail(f"the high band was not served in full: {hi}")
    if not lo["rejected"]:
        fail(f"the low band's small queue never pushed back: {lo}")
    # host time of one TinyLFU sketch update at this archive's width (the
    # admission filter records each plan's sightings up to three times)
    sketch = FrequencySketch(ga.store.decoder.da.n_blocks)
    seen = np.random.default_rng(SEED + 15).integers(0, sketch.width, 64)
    t0 = time.perf_counter()
    for _ in range(20):
        sketch.add(seen)
    sketch_add_ms = (time.perf_counter() - t0) * 1e3 / 20
    emit({"phase": "serve", "raw_bytes": ga.raw_size, "n_reads": ga.n_reads,
          "cache_blocks": CACHE_BLOCKS, "floors": SERVE_FLOOR,
          "zipf_keys": keys, "zipf_s": 1.1,
          "deadline_us": SERVE_DEADLINE_US,
          "span_bytes": 4 * BLOCK, "closed_loop": loop,
          "sketch_width": sketch.width, "sketch_add_ms_64_keys": sketch_add_ms,
          "burst": report(burst, brep, info1),
          "cache_info": ga.cache_info(), "launches": launches})
    return launches


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card: this smoke runs the port on the GPU only")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    t_start = time.perf_counter()
    smi = phase_device()
    small_err = phase_kernels_vs_plain()
    corpus, index, store, tiled, a16 = phase_resident()
    paths = {}
    paths["decode"], dec_calls = phase_decode(corpus, store)
    paths["fetch"], fetch_calls = phase_fetch(corpus, index, store)
    timing = phase_timing(store)
    profile = phase_profile(store, a16)
    paths["global"], window = phase_global()
    paths["mode1"] = phase_mode1(corpus, index, store)
    paths["stream"] = phase_stream(corpus, store)
    paths["cache"] = phase_cache(corpus, index, tiled)
    paths["heal"], heal_store, xor_wall_ms = phase_heal(corpus, index, a16)
    paths["partial"] = phase_partial(corpus, index, heal_store)
    del heal_store
    paths["serve"] = phase_serve(corpus, index, tiled)
    # the paths each kernel runs on, and those it must not
    runs_on = {"rans_decode": ("decode", "fetch", "global", "stream",
                               "cache", "heal", "partial", "serve"),
               "lz77_match": ("decode", "fetch", "mode1", "stream",
                              "cache", "heal", "partial", "serve")}
    for k, on in runs_on.items():
        for path, counts in paths.items():
            if (path in on) != bool(counts[k]):
                fail(f"{k} launched {counts[k]} times on the {path} path")
    emit({"phase": "summary", "elapsed_s": time.perf_counter() - t_start,
          "global_resolve_ms_per_window": window["resolve_ms_per_window"],
          "global_resolve_share": window["resolve_share_of_device"],
          "xor_rebuild_device_ms": profile["xor_rebuild"]["device_busy_ms"],
          "xor_rebuild_wall_ms": xor_wall_ms})
    replaces = {"rans_decode": "src/repro/kernels/rans_decode.py:32",
                "lz77_match": "src/repro/kernels/lz77_match.py:30"}
    print(smi, flush=True)
    emit({"kernels": [
        {"name": k, "route": "cuda",
         "source": f"src/repro_torch/csrc/{k}.cu", "replaces": replaces[k],
         "launches": sum(c[k] for c in paths.values()),
         "launches_by_path": {p: c[k] for p, c in paths.items()},
         "launches_per_decode_call": paths["decode"][k] / dec_calls,
         "launches_per_fetch_call": paths["fetch"][k] / fetch_calls,
         "max_abs_err": max(timing[k]["max_abs_err"], small_err),
         "ms": timing[k]["ms"], "plain_ms": timing[k]["plain_ms"],
         "bound_ms": timing[k]["bound_ms"],
         "bound_by": timing[k]["bound_by"], "library_ms": None}
        for k in ("rans_decode", "lz77_match")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
