#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It builds both
CUDA kernels from `src/repro_torch/csrc/` with nvcc, holds each against
its plain PyTorch version, then drives the port's main path — Mode 2
device-resident decode of an "ra" archive and `fetch_reads` random
access — over an 8 GiB FASTQ corpus resident as compressed words, and
checks every decoded byte against the source. Each phase prints one JSON
line; the last line is `{"ok": true, "device": {...}}`. Any mismatch or
failure exits non-zero; without a CUDA card it exits non-zero at once.
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
    emit({"phase": "kernels_vs_plain", "cases": cases})
    return max(max(c["rans_max_abs_err"], c["lz77_max_abs_err"])
               for c in cases)


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
    return corpus, index, store


def phase_decode(corpus, store):
    import torch
    from repro_torch.kernels import ops
    dec = store.decoder
    n = len(corpus)
    ops.reset_launches()
    t0 = time.perf_counter()
    out = dec.decode_all(chunk_blocks=CHUNK)
    decode_s = time.perf_counter() - t0
    chunks = -(-dec.da.n_blocks // CHUNK)
    # one chunk past 4 GiB decodes again with on-device digest checks
    lo = (dec.da.n_blocks // 2 + CHUNK) // CHUNK * CHUNK
    t0 = time.perf_counter()
    rows = dec.decode_blocks(np.arange(lo, lo + CHUNK), verify=True)
    sync()
    verified_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    src = np.frombuffer(corpus, np.uint8)
    if out.size != n * TILES or any(
            not np.array_equal(out[t * n:(t + 1) * n], src)
            for t in range(TILES)):
        fail("decode_all is not bit-perfect against the source")
    per_tile = n // BLOCK
    want = np.tile(src.reshape(per_tile, BLOCK), (CHUNK // per_tile + 1, 1))
    off = lo % per_tile
    if not np.array_equal(rows.cpu().numpy(), want[off:off + CHUNK]):
        fail("the verified chunk is not the source")
    emit({"phase": "decode", "raw_bytes": int(out.size), "chunks": chunks,
          "chunk_blocks": CHUNK, "decode_s": decode_s,
          "decode_GBps": out.size / decode_s / 1e9,
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


def phase_profile(store):
    """Device busy time and idle share of one decode chunk and one B=256
    fetch, and every kernel that ran on the device: launches and device
    ms by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 1)
    d = store.decoder
    ids = rng.integers(0, store.index.n_reads, 256)
    result = {}
    for name, fn in (
            ("decode_chunk", lambda: d.decode_blocks(np.arange(CHUNK))),
            ("fetch_b256", lambda: store.fetch_reads(ids))):
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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card: this smoke runs the port on the GPU only")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    t_start = time.perf_counter()
    smi = phase_device()
    small_err = phase_kernels_vs_plain()
    corpus, index, store = phase_resident()
    dec_launches, dec_calls = phase_decode(corpus, store)
    fetch_launches, fetch_calls = phase_fetch(corpus, index, store)
    timing = phase_timing(store)
    phase_profile(store)
    for k in ("rans_decode", "lz77_match"):
        if not dec_launches[k] or not fetch_launches[k]:
            fail(f"{k} was not launched on the main path: decode "
                 f"{dec_launches[k]}, fetch {fetch_launches[k]}")
    emit({"phase": "summary", "elapsed_s": time.perf_counter() - t_start})
    replaces = {"rans_decode": "src/repro/kernels/rans_decode.py:32",
                "lz77_match": "src/repro/kernels/lz77_match.py:30"}
    print(smi, flush=True)
    emit({"kernels": [
        {"name": k, "route": "cuda",
         "source": f"src/repro_torch/csrc/{k}.cu", "replaces": replaces[k],
         "launches": dec_launches[k] + fetch_launches[k],
         "launches_decode": dec_launches[k],
         "launches_fetch": fetch_launches[k],
         "launches_per_decode_call": dec_launches[k] / dec_calls,
         "launches_per_fetch_call": fetch_launches[k] / fetch_calls,
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
