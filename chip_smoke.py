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
`ServingFrontend` over the 8 GiB store under closed-loop traffic. Then
the model paths: qwen2-1.5b at full width and depth trained from the
8 GiB store (with compressed checkpoints at the reduced config), the
encode autotuner swept on the card, and the same model served by
`ServeSession` (KV-cache decode) from the 8 GiB store, each held against
the CPU at 2 layers; and the serving launcher in a process of its own.
Multi-device residency: the 8 GiB store partitioned over a 4-shard mesh
(on the one card, or one card a shard where there are four), read
through `ShardedExecutor`, streamed per shard, cached per shard and
healed after a lost shard; and data-parallel training of the same model
in an NCCL world of one, with and without the int8 gradient all-reduce.
The non-dense model families: qwen3-moe-235b-a22b, xlstm-350m,
recurrentgemma-2b, whisper-medium and qwen2-vl-2b at their published
widths, each trained and served from the 8 GiB store, and each held in
fp32 against the CPU at its smallest full block pattern.
The roofline: every measured train and decode step is counted once more
on the card (and on meta tensors, which must count the same FLOPs) and
printed beside its model FLOPs, MFU and roofline share on the H100's
data-sheet peaks; the train state's bytes on the card are held against
the dry-run's reckoning; and the dry-run itself
(`python -m repro_torch.launch.dryrun`, meta tensors over a fake
256-rank world) runs for qwen2-1.5b on the single-pod mesh, held on
this machine's own PyTorch to train_4k's FLOPs within 1-2x the model
FLOPs, its temp below 128 GB, its collective bytes within a band and
the replicate fallbacks' share of them at most 0.2; from the plain
families on, the port's four examples (`examples/*_torch.py`) run on
the card, each in a process of its own, both kernels launched on each.
Host encodes run in worker processes from the start.
It checks every decoded and served byte against the source. Each phase
prints one JSON line, with `t_s`, the seconds so far; the last line is
`{"ok": true, "device": {...}}`.
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
TRAIN_ARCH = "qwen2-1.5b"         # train phase: full width, full depth
TRAIN_SEQ = 255                   # 256-byte records cut from the reads
TRAIN_BATCH = 8
TRAIN_PREFETCH = 2
TRAIN_STEPS = 8                   # per-step steps, then
TRAIN_WINDOWS = 2                 # windows of
TRAIN_UNROLL = 2                  # steps each
TRAIN_LR = 3e-4
PLAIN_LAYERS = 2                  # train_plain: full width, 2 layers, B=1
# train_plain bounds, relative: loss and global gradient norm, and the
# relative norm of each leaf's gradient
PLAIN_TOL = {"loss": 1e-3, "grad_norm": 1e-3, "grad": 5e-2}
RESILIENT_READS = 2000            # train_resilient: corpus of the reduced
RESILIENT_STEPS = 8               # config's run, its steps, checkpoints
RESILIENT_CKPT_EVERY = 2          # every 2 steps and one failure
RESILIENT_FAIL_AT = 5             # injected at step 5
TUNE_SAMPLE = 1 << 20             # tune: the whole records of the "ra"
TUNE_ITERS = 2                    # corpus's first MiB, best of 2 timings
SERVE_B = 16                      # serve_model: TRAIN_ARCH as published,
SERVE_CTX = 128                   # B uniform read ids, contexts of this
SERVE_NEW = 32                    # many bytes, this many new tokens
PLAIN_SERVE = {"B": 2, "ctx": 32, "new": 8}   # serve_model_plain, at
PLAIN_SERVE_TOL = 1e-2            # PLAIN_LAYERS: logits' relative norm
SHARDS = 4                        # shard: the 8 GiB store over 4 shards
SHARD_B1 = 100                    # B=1 fetches through ShardedExecutor,
SHARD_BATCHES = 64                # then B=256 batches of uniform ids;
SHARD_CACHE = 2048                # cache slots a shard (8192 in all)
SHARD_HEAL = 4096                 # blocks read after a shard is lost
DP_STEPS = 3                      # train_dp: 2-layer steps, DP vs plain,
DP_FULL_STEPS = 4                 # then full-depth steps each way
# families: each non-dense config at its published widths from the
# 8 GiB store, trained (FAMILY_STEPS steps of FAMILY_BATCH records) and
# served as serve_model is (SERVE_B reads, SERVE_CTX, SERVE_NEW). Depth
# is cut only where one card cannot hold the weights, gradients and
# AdamW moments beside the resident corpus (PERF.md §4 has the
# reckoning); T is the record length less one.
FAMILIES = {
    "qwen3-moe-235b-a22b": {"seq": 255, "train_layers": 1,
                            "serve_layers": 2},
    "xlstm-350m": {"seq": 256},           # the mLSTM chunk needs T % 128
    "recurrentgemma-2b": {"seq": 255},
    "whisper-medium": {"seq": 255, "remat": "full"},  # 1500-frame encoder
    "qwen2-vl-2b": {"seq": 511},          # 256 image positions + text
}
FAMILY_BATCH = 8
FAMILY_STEPS = 4                  # the first is the warm-up
# families_plain: the smallest depth holding every block kind of the
# family (MoE and VLM 2 layers; whisper 2 encoder + 2 decoder layers;
# RG-LRU one (rec, rec, attn) group + one tail layer; xLSTM one group of
# 3 mLSTM + 1 sLSTM), fp32 weights on the card and on the CPU, one
# record; then PLAIN_FAMILY_SERVE["new"] greedy tokens after
# PLAIN_FAMILY_SERVE["ctx"] context bytes, and the card teacher-forced
# on the CPU's sequence
PLAIN_FAMILY_LAYERS = {"moe": 2, "vlm": 2, "whisper": 2, "rglru": 4,
                       "xlstm": 4}
PLAIN_FAMILY_SERVE = {"B": 2, "ctx": 4, "new": 5}
# (fp32; the RG-LRU's sqrt(1 - exp(2·a_log)) cancels as a_log → 0, so
# one ulp of exp moves it by about 1e-4: its reduced card tests read
# 4.3e-4 on decode logits, every other family's 5e-6 or less. Every
# family casts the embedding to bf16 before its lookup, as the reference
# does, so the embedding's gradient is a bf16 sum, in another order on
# the card, over every position of a token: the zero padding of a
# 512-byte record puts about 200 terms in one row. It read 2.4e-2
# (xLSTM, T=256) and 7.8e-2 (the VLM, T=511) against every other leaf's
# 5e-5 or less; a wrong gradient reads about 1)
PLAIN_FAMILY_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "grad": 1e-2,
                    "grad_embed": 0.2, "logits": 5e-3}
ROOFLINE_ARCH = "qwen2-1.5b"       # roofline: the dry-run's cells of
ROOFLINE_MESH = "single"           # this arch on this mesh
ROOFLINE_TIMEOUT_S = 300
ROOFLINE_FLOPS_RATIO = (1.0, 2.0)  # train_4k FLOPs x cards / model FLOPs
ROOFLINE_REPLICATE_SHARE = 0.2     # replicate fallbacks' collective share
ROOFLINE_TEMP_MAX = 128e9          # train_4k temp_size_in_bytes a card
# train_4k's collective bytes a card: half the lower and twice the higher
# of two DTensors' readings (2.11: 3.666e10, 2.13: 1.524e11)
ROOFLINE_COLLECTIVE_BYTES = (1.8e10, 3.0e11)
EXAMPLES = {                       # examples/<name>_torch.py at their
    "quickstart": [],              # own sizes, and the flags the examples
    "serve_compressed_resident": [],                    # phase passes
    "train_compressed_resident": [
        "--ckpt-dir", os.path.join(ROOT, "build", "examples_ckpt")],
    "elastic_restart": [],
}
EXAMPLES_TIMEOUT_S = 300
ENCODE_TIMEOUT_S = 600             # phase_global's wait for its encodes
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


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's carries `t_s`, the smoke's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
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


PROFILE_TRIES = {}      # kernel -> most profiles one kernel_ms call took


def kernel_ms(fn, kernel: str, reps: int) -> float:
    """Mean device duration of the CUDA kernel whose name holds `kernel`
    over `reps` calls of `fn`, from the profiler's kernel records: host
    time between launches, which CUDA events around back-to-back calls
    would count, is left out. When the profiler drops a kernel record it
    measures again, three times at most; the tries go to PROFILE_TRIES
    and the kernels line."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and kernel in e.name]
        seen.append(len(us))
        if len(us) == reps:
            PROFILE_TRIES[kernel] = max(PROFILE_TRIES.get(kernel, 0),
                                        len(seen))
            return sum(us) / reps / 1e3
    fail(f"profiler saw {seen} launches of {kernel} in three tries, not "
         f"{reps}")


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
    stores), 16 KiB, 32 KiB (the last 16-bit pointer size), 64 KiB (the
    autotuner's larger block: 4 offset planes, i32 pointers in global
    scratch) and 1 MiB, for rANS CTAs of 1, 4, 8 and 16 blocks, with the
    archive's rounds, the early-exit resolver and one round short."""
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
                                 (64 * 1024, 5000, "platinum"),
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


def phase_resident(encodes):
    from repro_torch.core.index import ReadIndex
    from repro_torch.core.residency import CompressedResidentStore
    from repro_torch.data.tiling import tile_archive, tile_index
    import torch
    t0 = time.perf_counter()
    corpus, a, encode_s = encodes["ra"].get(timeout=ENCODE_TIMEOUT_S)
    encode_wait_s = time.perf_counter() - t0
    index = ReadIndex.build(corpus, BLOCK)
    tiled = tile_archive(a, TILES)
    store = CompressedResidentStore(
        tiled, tile_index(index, TILES, len(corpus)), device=DEVICE)
    sync()
    st = store.stats()
    emit({"phase": "resident", "encode_s": encode_s,
          "encode_wait_s": encode_wait_s, "corpus_bytes": len(corpus), "tiles": TILES,
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
    """Collect garbage (a cycle of an earlier phase's tensors freed inside
    the window would read as less memory taken), reset the peak counter;
    the bytes allocated now are the base."""
    import gc
    import torch
    gc.collect()
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


def _encode(blocks: int, seed: int, **kw):
    """(source, archive, encode seconds): `blocks` aligned FASTQ blocks
    encoded with `kw`, in a worker process."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.encoder import encode
    from repro_torch.data.tiling import aligned_fastq
    corpus = aligned_fastq(blocks, BLOCK, seed=seed)
    t0 = time.perf_counter()
    a = encode(corpus, block_size=BLOCK, **kw)
    return corpus, a, time.perf_counter() - t0


def start_encodes():
    """Starts the smoke's host encodes in three spawned worker processes
    (no CUDA state forked), in the order the phases take them, so that
    they run beside the card's earlier phases: the "ra" corpus of
    `phase_resident`, then `phase_global`'s anchored archive, its
    anchor-free ones (FREE_BLOCKS and a quarter of it) and the one
    across 2^32. Returns (pool, {name: async result})."""
    import multiprocessing
    glob_ = {"mode": "global"}
    jobs = {"ra": (CORPUS_BLOCKS, SEED, {}),
            "anchored": (GLOBAL_BLOCKS, SEED + 2,
                         {**glob_, "anchor_interval": ANCHOR}),
            "free": (FREE_BLOCKS, SEED + 3, glob_),
            "small": (FREE_BLOCKS // 4, SEED + 5, glob_),
            "wrap": (WRAP_BLOCKS, SEED + 4,
                     {**glob_, "anchor_interval": ANCHOR,
                      "origin": WRAP_ORIGIN})}
    pool = multiprocessing.get_context("spawn").Pool(3)
    return pool, {k: pool.apply_async(_encode, (b, sd), kw)
                  for k, (b, sd, kw) in jobs.items()}


def phase_global(pool, encodes):
    """Global (wavefront) archives through the query plane: a 64 MiB
    anchored archive behind `GenomicArchive` (decode_all, windows,
    mixed queries, cache co-install, stream), a 16 MiB anchor-free one
    and 1 MiB placed across 2^32, each encoded by `start_encodes` while
    earlier phases ran."""
    import torch
    from repro_torch.api import ByteRange, GenomicArchive, ReadId, Region
    from repro_torch.api.executors import StreamingExecutor
    from repro_torch.core.decoder import Decoder
    from repro_torch.core.index import ReadIndex, parse_fastq_records
    from repro_torch.core.residency import CompressedResidentStore
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED + 2)
    t0 = time.perf_counter()
    corpus, a, encode_s = encodes["anchored"].get(timeout=ENCODE_TIMEOUT_S)
    encode_wait_s = time.perf_counter() - t0
    src = np.frombuffer(corpus, np.uint8)
    starts, names = parse_fastq_records(corpus)
    # what GenomicArchive.from_bytes builds around its encode (the tune
    # phase and the examples drive from_bytes itself)
    t0 = time.perf_counter()
    ga = GenomicArchive(CompressedResidentStore(
        a, ReadIndex(starts=starts, block_size=a.block_size), device=DEVICE,
        cache_blocks=256), names=names)
    build_s = time.perf_counter() - t0
    starts = starts.astype(np.int64)
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
    anchored = {"corpus_bytes": len(corpus), "encode_s": encode_s,
                "encode_wait_s": encode_wait_s, "build_s": build_s,
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
    t0 = time.perf_counter()
    corpus, a, encode_s = encodes["free"].get(timeout=ENCODE_TIMEOUT_S)
    (small, a_small, _), wrapped = (
        encodes[k].get(timeout=ENCODE_TIMEOUT_S) for k in ("small", "wrap"))
    encode_wait_s = time.perf_counter() - t0
    pool.close()
    pool.join()
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
    ds = Decoder(a_small, device=DEVICE)
    base = _reset_peak()
    if ds.decode_all().tobytes() != small:
        fail("the small anchor-free archive does not decode to its source")
    peak_small = _peak_above(base)
    slope = (peak - peak_small) / (len(corpus) - len(small))
    fixed = peak - slope * len(corpus)
    resident = ds.da.device_bytes / len(small)
    del ds
    free = {"corpus_bytes": len(corpus), "encode_s": encode_s,
            "encode_wait_s": encode_wait_s, "decode_all_s": free_s, "max_depth": a.max_depth,
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
    corpus, a, _ = wrapped
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


def train_config(n_layers=None):
    """The train phases' model: `TRAIN_ARCH` as published, or cut to
    `n_layers` layers (widths unchanged)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH)
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def _check_tokens(batch, ids, corpus, starts, what: str,
                  seq: int = TRAIN_SEQ) -> None:
    """Each row's tokens and labels must be its read's source bytes
    (tile and local id), cut or zero-padded to seq + 1."""
    n_reads = starts.size - 1
    rec = seq + 1
    toks = batch["tokens"].cpu().numpy().reshape(-1, seq)
    labs = batch["labels"].cpu().numpy().reshape(-1, seq)
    if len(ids) != toks.shape[0]:
        fail(f"{what}: {toks.shape[0]} rows for {len(ids)} ids")
    for i, r in enumerate(ids):
        lr = int(r) % n_reads
        src = np.frombuffer(corpus[starts[lr]:starts[lr + 1]][:rec],
                            np.uint8)
        want = np.zeros(rec, np.int64)
        want[:src.size] = src
        if not (np.array_equal(toks[i], want[:-1])
                and np.array_equal(labs[i], want[1:])):
            fail(f"{what}: row {i} (read {int(r)}) is not the source bytes")


def _profile_steps(fn, n: int) -> dict:
    """Device busy share, top five device ops and the decode kernels'
    share of `n` calls of `fn`, from the profiler's kernel records."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops_ms = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            c, ms = ops_ms.get(e.name, (0, 0.0))
            ops_ms[e.name] = (c + 1, ms + e.time_range.elapsed_us() / 1e3)
    busy = sum(ms for _, ms in ops_ms.values())

    def share(keys):
        return sum(ms for k, (_, ms) in ops_ms.items()
                   if any(w in k for w in keys))

    decode = share(("rans_decode_kernel", "lz77_match_kernel"))
    matmul = share(("gemm", "nvjet", "cutlass", "xmma", "sm90_"))
    top = sorted(ops_ms.items(), key=lambda kv: -kv[1][1])[:5]
    return {"steps": n, "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "device_launches": sum(c for c, _ in ops_ms.values()),
            "decode_kernels_ms": decode,
            "decode_kernels_share_of_busy": decode / max(busy, 1e-9),
            "matmul_ms": matmul,
            "matmul_share_of_busy": matmul / max(busy, 1e-9),
            "top5_device_ops": [[k[:90], c, ms] for k, (c, ms) in top]}


def _step_roofline(fn, args, model_flops: float, step_ms: float,
                   what: str) -> dict:
    """One extra call of `fn(*args)` (a measured step) counted on the
    card, and the same step counted on meta tensors: their FLOPs must be
    equal. → `step_roofline` (model and counted FLOPs, bytes, MFU, the
    roofline time on the H100 constants and its share of `step_ms`),
    with the meta count's live-bytes estimate and the card's name."""
    from repro_torch.roofline.step import count_step, meta_like, step_roofline
    card = count_step(fn, *args, device=DEVICE)
    meta = count_step(fn, *meta_like(args), device="meta")
    if card["flops"] != meta["flops"]:
        fail(f"{what}: {card['flops']} FLOPs counted on the card, "
             f"{meta['flops']} on meta tensors")
    out = step_roofline(model_flops, card, step_ms / 1e3)
    out.update(meta_flops=meta["flops"], meta_bytes=meta["bytes"],
               temp_estimate_bytes=meta["temp"], nvidia_smi=nvidia_smi())
    if not 0 < out["mfu"] <= 1:
        fail(f"{what}: mfu {out['mfu']} outside (0, 1]")
    return out


def _no_grad(fn):
    def run(*a):
        import torch
        with torch.no_grad():
            return fn(*a)
    return run


def _state_reckoning(cfg) -> int:
    """The train state's bytes on one card as the dry-run reckons them:
    `build_cell` of the train phase's shape on a one-card (1, 1) mesh,
    the state's argument bytes."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import build_cell, per_device_bytes
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"), [DEVICE])
    shape = ShapeConfig("train_phase", TRAIN_SEQ, TRAIN_BATCH, "train")
    _, args, in_sh, _, _, _ = build_cell(cfg, shape, mesh)
    return per_device_bytes(args[0], in_sh[0])


def phase_train(corpus, index, store):
    """`TRAIN_ARCH` at full width and depth (bf16 params, fp32 AdamW
    moments, on the card) trained from the 8 GiB resident store through
    `GenomicArchive.dataset`: TRAIN_STEPS per-step steps, then
    TRAIN_WINDOWS windows of TRAIN_UNROLL steps through the unrolled
    step. Every batch's tokens are checked against the source bytes of
    its sampled reads; losses must be finite and fall."""
    import torch
    from repro_torch.api import GenomicArchive
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step,
                                                 make_unrolled_train_step)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for fp32 matmuls; the port's fp32 products need "
             "it off")
    starts = np.asarray(index.starts, np.int64)
    ga = GenomicArchive(store)
    cfg = train_config()
    model = build_model(cfg)
    total = TRAIN_STEPS + TRAIN_WINDOWS * TRAIN_UNROLL
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=total)
    base = _reset_peak()
    t0 = time.perf_counter()
    state = init_train_state(
        model, torch.Generator(device=DEVICE).manual_seed(SEED), opt)
    sync()
    init_s = time.perf_counter() - t0
    state_growth = torch.cuda.memory_allocated() - base
    leaves = (list(state["params"].values()) + list(state["opt"]["m"].values())
              + list(state["opt"]["v"].values()))
    state_bytes = sum(t.numel() * t.element_size() for t in leaves)
    n_params = sum(v.numel() for v in state["params"].values())
    del leaves
    ds = ga.dataset(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                    prefetch=TRAIN_PREFETCH, seed=SEED)
    step = make_train_step(model, opt, remat="none")
    losses, step_ms, wait_ms, seen = [], [], [], []
    run = {"state": state}
    del state
    ops.reset_launches()
    it = iter(ds)

    def one(i):
        t0 = time.perf_counter()
        b = next(it)
        t1 = time.perf_counter()
        run["state"], m = step(run["state"], b)
        losses.append(float(m["loss"]))   # waits for the step
        t2 = time.perf_counter()
        seen.append((b, ds.sampler.sample(i)))
        return (t1 - t0) * 1e3, (t2 - t1) * 1e3

    for i in range(TRAIN_STEPS - 2):
        w_ms, s_ms = one(i)
        wait_ms.append(w_ms)
        step_ms.append(s_ms)
    last_two = iter(range(TRAIN_STEPS - 2, TRAIN_STEPS))
    profiled = _profile_steps(lambda: one(next(last_two)), 2)
    pf = ds.prefetch_stats()
    ds.close()
    unrolled = make_unrolled_train_step(model, opt, remat="none")
    window_ms = []
    wit = ds.windows(TRAIN_UNROLL)
    for w in range(TRAIN_WINDOWS):
        t0 = time.perf_counter()
        win = next(wit)
        first = ds.step - TRAIN_UNROLL
        run["state"], ms = unrolled(run["state"], win)
        losses.extend(ms["loss"].tolist())
        window_ms.append((time.perf_counter() - t0) * 1e3)
        seen.append((win, np.concatenate(
            [ds.sampler.sample(first + u) for u in range(TRAIN_UNROLL)])))
    pf_windows = ds.prefetch_stats()
    ds.close()
    launches = dict(ops.LAUNCHES)
    peak = _peak_above(base)
    for n, (b, ids) in enumerate(seen):
        _check_tokens(b, ids, corpus, starts, f"train batch {n}")
    state = run.pop("state")
    timed = step_ms[1:] or step_ms
    tokens = TRAIN_BATCH * TRAIN_SEQ
    from repro_torch.roofline import hlo_costs as rl
    roof = _step_roofline(step, (state, seen[0][0]),
                          rl.model_flops_train(cfg, tokens),
                          float(np.median(timed)), "train")
    reckoned = _state_reckoning(cfg)
    memory = {"state_bytes_reckoned": reckoned,
              "state_bytes_allocated": state_growth,
              "allocated_over_reckoned": state_growth / reckoned,
              "temp_estimate_bytes": roof["temp_estimate_bytes"],
              "max_memory_allocated_above_residency": _peak_above(base)}
    if "device_busy_ms" in profiled:      # against the unprofiled steps
        profiled["busy_share_of_median_steps"] = (
            profiled["device_busy_ms"] / (2 * float(np.median(timed))))
    out = {"phase": "train", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_params": n_params,
           "param_dtype": str(state["params"]["embed"].dtype),
           "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
           "n_reads": ga.n_reads, "init_s": init_s,
           "state_bytes": state_bytes, "losses": losses,
           "step_ms": step_ms, "step_ms_median": float(np.median(timed)),
           "tokens_per_s": tokens / (float(np.median(timed)) / 1e3),
           "consumer_wait_ms": wait_ms, "window_ms": window_ms,
           "prefetch": pf, "prefetch_windows": pf_windows,
           "peak_bytes_above_residency": peak, "profile": profiled,
           "tf32": torch.backends.cuda.matmul.allow_tf32,
           "deterministic_algorithms":
               torch.are_deterministic_algorithms_enabled(),
           "batches_checked": len(seen),
           "roofline": roof, "memory": memory,
           "launches": launches}
    emit(out)
    if not reckoned <= state_growth <= 1.01 * reckoned:
        fail(f"train: the state took {state_growth} bytes on the card, the "
             f"dry-run reckons {reckoned}")
    if not all(np.isfinite(losses)):
        fail(f"a train loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"the train loss did not fall: {losses}")
    del state, model
    torch.cuda.empty_cache()
    return launches, out


def phase_train_plain(store):
    """The slice's card-against-plain check: `TRAIN_ARCH` at full width
    cut to PLAIN_LAYERS layers, one batch of one 256-byte record, the
    same weights on the card and on the CPU (the plain path): the loss
    and the gradient norm within PLAIN_TOL["loss"] / ["grad_norm"]
    relative, and the gradient of every leaf within PLAIN_TOL["grad"]
    relative norm (the bf16 gradient bound of test_torch_models.py)."""
    import torch
    from repro_torch.api import GenomicArchive
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import global_norm
    model = build_model(train_config(PLAIN_LAYERS))
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED + 1))
    batch = GenomicArchive(store).dataset(
        batch_size=1, seq_len=TRAIN_SEQ, prefetch=0, seed=SEED + 1).batch_at(0)
    got = {}
    for dev in (DEVICE, "cpu"):
        leaves = {k: v.to(dev).requires_grad_(True)
                  for k, v in params.items()}
        b = {k: v.to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        loss = model.loss(leaves, b, remat="none")
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        gn = float(global_norm(grads))
        got[dev] = (loss.item(), gn, time.perf_counter() - t0,
                    {k: g.to("cpu", torch.float32) for k, g in grads.items()})
        del leaves, grads, loss
    (lc, gc, tc, grc), (lp, gp, tp, grp) = got[DEVICE], got["cpu"]
    leaf_err = {k: float((grc[k] - grp[k]).norm() / grp[k].norm())
                for k in grp}
    worst = max(leaf_err, key=leaf_err.get)
    out = {"phase": "train_plain", "n_layers": PLAIN_LAYERS,
           "batch": 1, "seq_len": TRAIN_SEQ, "loss_card": lc,
           "loss_plain": lp, "loss_rel_err": abs(lc - lp) / abs(lp),
           "grad_norm_card": gc, "grad_norm_plain": gp,
           "grad_norm_rel_err": abs(gc - gp) / abs(gp),
           "grad_leaf_rel_err": leaf_err, "grad_leaf_worst": worst,
           "card_s": tc, "plain_s": tp, "tolerance": PLAIN_TOL}
    emit(out)
    bad = [k for k, e in leaf_err.items() if not e <= PLAIN_TOL["grad"]]
    if not (out["loss_rel_err"] <= PLAIN_TOL["loss"]
            and out["grad_norm_rel_err"] <= PLAIN_TOL["grad_norm"]) or bad:
        fail(f"the card's loss or gradients are not the plain path's "
             f"(leaves past the bound: {bad}): {out}")
    del params, grc, grp
    torch.cuda.empty_cache()
    return out


def shard_mesh():
    """The shard phase's mesh of SHARDS shards: one card a shard where
    the machine has that many cards, else every shard on the card."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    if DEVICE == "cuda" and torch.cuda.device_count() >= SHARDS:
        return (make_mesh((SHARDS,), ("data",),
                          [f"cuda:{i}" for i in range(SHARDS)]),
                "one card a shard")
    return (make_mesh((SHARDS,), ("data",), [DEVICE] * SHARDS),
            f"{SHARDS} shards on one {DEVICE} device")


def _blocks_of_source(src: np.ndarray, blocks) -> np.ndarray:
    """The source rows of tiled blocks `blocks` (the corpus is a whole
    number of blocks, tiled end to end)."""
    per_tile = src.size // BLOCK
    return src.reshape(per_tile, BLOCK)[np.asarray(blocks) % per_tile]


def phase_shard(corpus, index, store):
    """The 8 GiB "ra" store partitioned over a SHARDS-shard mesh
    (`CompressedResidentStore.attach_sharded`): the replicated regime on
    a 4096-block chunk against `Decoder.decode_blocks`; `ShardedExecutor`
    fetches of B=1 and B=256 uniform read ids; `StreamingExecutor
    (sharded=...)` over all 8 GiB at the stream phase's budget; a
    per-shard cache of SHARD_CACHE slots under the cache phase's Zipf
    batches; a lost shard healed under `on_error="repair"`; the
    frontend's device budget. Every decoded byte is checked against the
    source. The partition is released at the end."""
    import torch
    from repro_torch.api import ByteRange, GenomicArchive
    from repro_torch.api.executors import ShardedExecutor, StreamingExecutor
    from repro_torch.api.plan import QueryPlanner
    from repro_torch.core.sharded_decode import sharded_decode_blocks
    from repro_torch.kernels import ops
    from repro_torch.resilience.faults import FaultInjector
    from repro_torch.serving.frontend import ServingFrontend
    mesh, placement = shard_mesh()
    src = np.frombuffer(corpus, np.uint8)
    starts = np.asarray(index.starts, np.int64)
    dec = store.decoder
    da = dec.da
    n_blocks = da.n_blocks
    n_reads = store.index.n_reads
    planner = QueryPlanner(store)
    rng = np.random.default_rng(SEED + 18)
    out = {"phase": "shard", "shards": SHARDS, "placement": placement,
           "devices": [str(d) for d in mesh.devices.flat]}
    ops.reset_launches()
    # the partition
    base = _reset_peak()
    t0 = time.perf_counter()
    sr = store.attach_sharded(mesh)
    sync()
    out["partition_s"] = time.perf_counter() - t0
    part = sr.part
    flat_bytes = da.device_bytes
    # the flat store keeps i64 word offsets; the reference's count is i32
    flat_ref_bytes = flat_bytes - da.word_off.numel() * 4
    out.update({
        "bounds": part.bounds.tolist(), "nb_max": part.nb_max,
        "w_max": part.w_max, "per_shard_bytes": sr.per_shard_bytes(),
        "device_bytes": sr.device_bytes(),
        "flat_compressed_device_bytes": flat_bytes,
        "per_shard_over_flat": sr.per_shard_bytes() / flat_bytes,
        "per_shard_over_flat_i32_offsets":
            sr.per_shard_bytes() / flat_ref_bytes,
        "partition_peak_bytes_above_residency": _peak_above(base)})
    # the replicated regime: a 4096-block chunk across the shard bounds
    lo = int(part.bounds[1]) - CHUNK // 2
    sel = np.arange(lo, lo + CHUNK)
    for name, fn in (("replicated", lambda: sharded_decode_blocks(
            dec, sel, mesh)), ("flat", lambda: dec.decode_blocks(sel))):
        fn()                                   # warm-up
        sync()
        t0 = time.perf_counter()
        rows = fn()
        sync()
        out[f"{name}_chunk_ms"] = (time.perf_counter() - t0) * 1e3
        del rows
    rep = sharded_decode_blocks(dec, sel, mesh)
    flat = dec.decode_blocks(sel)
    if not torch.equal(rep, flat) or not np.array_equal(
            rep.cpu().numpy(), _blocks_of_source(src, sel)):
        fail("the replicated sharded chunk is not Decoder.decode_blocks's "
             "rows or the source")
    del rep, flat
    # ShardedExecutor on the partition: B=1 and B=256 fetches
    sx = ShardedExecutor(store, mesh, residency="partition")
    if sx.sharded is not sr:
        fail("ShardedExecutor did not reuse the attached partition")
    sx.run(planner.plan_read_ids(rng.integers(0, n_reads, 256)))
    sync()
    l0 = dict(ops.LAUNCHES)
    b1_ms, got = [], []
    for r in rng.integers(0, n_reads, SHARD_B1):
        t0 = time.perf_counter()
        rows, lens = sx.run(planner.plan_read_ids(np.array([r])))
        sync()
        b1_ms.append((time.perf_counter() - t0) * 1e3)
        got.append((rows, lens, [r]))
    l1 = dict(ops.LAUNCHES)
    ids_b = [rng.integers(0, n_reads, 256) for _ in range(SHARD_BATCHES)]
    t0 = time.perf_counter()
    for ids in ids_b:
        got.append((*sx.run(planner.plan_read_ids(ids)), ids))
    sync()
    b256_s = time.perf_counter() - t0
    l2 = dict(ops.LAUNCHES)
    for rows, lens, ids in got:
        _check_reads(rows, lens, ids, corpus, starts)
    del got
    out.update({
        "b1_p50_ms": float(np.percentile(b1_ms, 50)),
        "b1_p90_ms": float(np.percentile(b1_ms, 90)),
        "b256_reads_per_s": 256 * SHARD_BATCHES / b256_s,
        "b256_ms_per_batch": b256_s * 1e3 / SHARD_BATCHES,
        "launches_per_b1_fetch": {k: (l1[k] - l0[k]) / SHARD_B1
                                  for k in l0},
        "launches_per_b256_fetch": {k: (l2[k] - l1[k]) / SHARD_BATCHES
                                    for k in l0},
        "reads_checked": SHARD_B1 + 256 * SHARD_BATCHES})
    # sharded streaming of all 8 GiB under the stream phase's budget
    whole = np.empty(da.raw_size, np.uint8)
    st = StreamingExecutor(store, max_resident_bytes=STREAM_BUDGET,
                           sharded=sr)
    base = _reset_peak()
    pos = 0
    t0 = time.perf_counter()
    for chunk in st.chunks([ByteRange(0, da.raw_size)]):
        whole[pos:pos + chunk.size] = chunk
        pos += chunk.size
    stream_s = time.perf_counter() - t0
    out["stream"] = {
        "bytes": pos, "chunks": len(st.chunk_log), "s": stream_s,
        "GBps": pos / stream_s / 1e9, "max_resident_bytes": STREAM_BUDGET,
        "peak_device_bytes_above_resident": _peak_above(base),
        "max_chunk_resident_bytes": max(c.resident_bytes
                                        for c in st.chunk_log)}
    check_all(whole[:pos], src, "sharded stream")
    del whole, st, sx, sr, part
    # the per-shard cache under the cache phase's Zipf(1.1) batches
    sx = ShardedExecutor(store, mesh, cache_blocks=SHARD_CACHE)
    cdf = np.cumsum(1.0 / np.arange(1, n_reads + 1) ** 1.1)
    cdf /= cdf[-1]
    perm = rng.permutation(n_reads)

    def batch():
        return perm[np.minimum(np.searchsorted(cdf, rng.random(256)),
                               n_reads - 1)]

    def run(n):
        info0 = sx.cache_info()
        got = []
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            ids = batch()
            got.append((*sx.run(planner.plan_read_ids(ids)), ids))
        sync()
        s = time.perf_counter() - t0
        for rows, lens, ids in got:
            _check_reads(rows, lens, ids, corpus, starts)
        info = sx.cache_info()
        hits = info["hits"] - info0["hits"]
        misses = info["misses"] - info0["misses"]
        return {"batches": n, "hit_rate": hits / (hits + misses),
                "reads_per_s": n * 256 / s,
                "evictions": info["evictions"] - info0["evictions"]}

    cold = run(64)
    fill = 0
    while sx.cache_info()["evictions"] == 0:
        if fill == 1024:
            fail(f"the sharded cache never evicted: {sx.cache_info()}")
        sx.run(planner.plan_read_ids(batch()))
        fill += 1
    steady = run(64)
    info = sx.cache_info()
    out["cache"] = {"slots_per_shard": SHARD_CACHE,
                    "slots": SHARD_CACHE * SHARDS, "cold": cold,
                    "batches_to_first_eviction": fill, "steady": steady,
                    "per_shard_resident": [p["resident"]
                                           for p in info["per_shard"]],
                    "buffer_bytes": info["buffer_bytes"]}
    del sx
    # a lost shard, healed from the host copy under on_error="repair"
    sr = store.attach_sharded(mesh, verify=True, on_error="repair")
    uniq = np.sort(rng.choice(n_blocks, SHARD_HEAL, replace=False))
    want = _blocks_of_source(src, uniq)
    sync()
    t0 = time.perf_counter()
    clean = sr.rows_for_blocks(uniq)
    sync()
    clean_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(clean.cpu().numpy(), want):
        fail("the verified sharded rows are not the source")
    del clean
    ev = FaultInjector(seed=18).drop_shard(sr, shard=1)
    t0 = time.perf_counter()
    healed = sr.rows_for_blocks(uniq)
    sync()
    heal_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(healed.cpu().numpy(), want):
        fail("rows after the lost shard are not the source")
    if sr.shard_rebuilds < 1:
        fail("the lost shard was not rebuilt")
    del healed
    owners = np.bincount(sr.part.shard_of(uniq), minlength=SHARDS)
    out["heal"] = {"event": ev, "blocks": SHARD_HEAL,
                   "blocks_per_shard": owners.tolist(),
                   "verified_clean_ms": clean_ms,
                   "heal_and_rebuild_ms": heal_ms,
                   "shard_rebuilds": sr.shard_rebuilds,
                   "recover_info": dec.recover_info()}
    if not owners.all():
        fail(f"the healed blocks miss a shard: {owners}")
    fe = ServingFrontend(GenomicArchive(store))
    out["frontend_device_bytes"] = fe.device_bytes()
    if fe.device_bytes() != sr.device_bytes():
        fail(f"ServingFrontend.device_bytes {fe.device_bytes()} != "
             f"{sr.device_bytes()}")
    launches = dict(ops.LAUNCHES)
    out["launches"] = launches
    emit(out)
    store.sharded = None
    del sr, fe
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return launches, out


def phase_train_dp(corpus, index, store):
    """Data-parallel training in an NCCL world of one
    (`repro_torch.launch.mesh.dp_group`) on `TRAIN_ARCH` as published,
    fed the train phase's batches from the 8 GiB store: at PLAIN_LAYERS
    layers, DP_STEPS `make_manual_dp_step` steps bit-equal to as many
    `make_train_step` steps from the same state (losses and every leaf);
    at full depth DP_FULL_STEPS steps uncompressed and with the int8
    gradient all-reduce (step ms, tokens/s, peak above residency, the
    compressed gradients' worst error over the quantum); then the
    launcher with --manual-dp --grad-compress in a process of its own."""
    import tempfile
    import torch
    from repro_torch.api import GenomicArchive
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import dp_group, make_local_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.training import grad_compress as gc
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (_loss_and_grads,
                                                 init_train_state,
                                                 make_manual_dp_step,
                                                 make_train_step)
    starts = np.asarray(index.starts, np.int64)
    ds = GenomicArchive(store).dataset(batch_size=TRAIN_BATCH,
                                       seq_len=TRAIN_SEQ, prefetch=0,
                                       seed=SEED)
    ops.reset_launches()
    batches = [ds.batch_at(i) for i in range(max(DP_STEPS, DP_FULL_STEPS))]
    for i, b in enumerate(batches):
        _check_tokens(b, ds.sampler.sample(i), corpus, starts,
                      f"train_dp batch {i}")
    out = {"phase": "train_dp", "arch": TRAIN_ARCH, "batch": TRAIN_BATCH,
           "seq_len": TRAIN_SEQ}
    with dp_group(DEVICE):
        mesh = make_local_mesh()
        out["world"] = mesh.size
        # PLAIN_LAYERS layers at full width: DP against the plain step
        model = build_model(train_config(PLAIN_LAYERS))
        opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=8)

        def fresh(m):
            return init_train_state(
                m, torch.Generator(device=DEVICE).manual_seed(SEED + 3), opt)

        plain, dp = fresh(model), fresh(model)
        step = make_train_step(model, opt, remat="none")
        dstep = make_manual_dp_step(model, opt, mesh, remat="none")
        same = []
        for i in range(DP_STEPS):
            plain, pm = step(plain, batches[i])
            dp, dm = dstep(dp, batches[i], 1)
            same.append(bool(torch.equal(pm["loss"], dm["loss"])))
        leaves_equal = all(torch.equal(plain[g][k], dp[g][k])
                           for g in ("params",) for k in plain[g]) and all(
            torch.equal(plain["opt"][m][k], dp["opt"][m][k])
            for m in ("m", "v") for k in plain["opt"][m])
        out["short"] = {"n_layers": PLAIN_LAYERS, "steps": DP_STEPS,
                        "losses_bit_equal": same,
                        "leaves_bit_equal": leaves_equal,
                        "losses": [float(pm["loss"])]}
        del plain, dp, model
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        if not (all(same) and leaves_equal):
            fail(f"the world-of-one DP step is not the plain step: {out}")
        # full depth, uncompressed then compressed
        model = build_model(train_config())
        opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                          total_steps=DP_FULL_STEPS)
        runs = {}
        for compress in (False, True):
            base = _reset_peak()
            state = fresh(model)
            dstep = make_manual_dp_step(model, opt, mesh, remat="none",
                                        compress=compress)
            losses, ms = [], []
            for i in range(DP_FULL_STEPS):
                sync()
                t0 = time.perf_counter()
                state, m = dstep(state, batches[i], 1)
                losses.append(float(m["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
            timed = ms[1:]
            runs["int8" if compress else "fp"] = {
                "losses": losses, "step_ms": ms,
                "step_ms_median": float(np.median(timed)),
                "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
                / (float(np.median(timed)) / 1e3),
                "peak_bytes_above_residency": _peak_above(base)}
            del state
            if DEVICE == "cuda":
                torch.cuda.empty_cache()
        # the compressed mean of one batch's gradients over the quantum
        params = model.init(
            torch.Generator(device=DEVICE).manual_seed(SEED + 3))
        # (in fp32: the step's bf16 gradients would add their own rounding
        # to the quantization error)
        _, grads = _loss_and_grads(model, params, batches[0], "none")
        grads = {k: g.float() for k, g in grads.items()}
        comp = gc.compress_tree_psum(grads, 1)
        q_err = {k: float((comp[k] - grads[k]).abs().max()
                          / (grads[k].abs().max().clamp_min(1e-12) / 127))
                 for k in grads}
        del params, grads, comp, model
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    worst = max(q_err, key=q_err.get)
    out.update({"full": {"n_layers": train_config().n_layers, **runs},
                "grad_err_over_quantum_max": q_err[worst],
                "grad_err_worst_leaf": worst,
                "step1_loss_diff": abs(runs["int8"]["losses"][0]
                                       - runs["fp"]["losses"][0])})
    for r in runs.values():
        if not all(np.isfinite(r["losses"])):
            fail(f"a data-parallel loss is not finite: {runs}")
    if out["step1_loss_diff"] > 0.05:
        fail(f"compressed step-1 loss off by {out['step1_loss_diff']}")
    if q_err[worst] > 1.01:
        fail(f"compressed gradients past one quantum: {worst} "
             f"{q_err[worst]}")
    launches = dict(ops.LAUNCHES)
    # the launcher, in a process of its own
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
             "--manual-dp", "--grad-compress", "--steps", "4", "--batch",
             "4", "--seq", "64", "--reads", "400", "--block", "4096",
             "--prefetch", "0", "--device", DEVICE, "--archive",
             os.path.join(d, "c.acegad"), "--ckpt-dir",
             os.path.join(d, "ck")],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    lines = res.stdout.splitlines()
    out["launcher"] = {"rc": res.returncode,
                       "s": time.perf_counter() - t0,
                       "lines": [ln for ln in lines
                                 if "data-parallel" in ln
                                 or "training complete" in ln]}
    out["launches"] = launches
    emit(out)
    if (res.returncode
            or "data-parallel over 1 rank(s) (grad_compress=True)"
            not in res.stdout or "training complete; 4" not in res.stdout):
        fail(f"train launcher --manual-dp: rc {res.returncode}: "
             f"{lines[-6:]} {res.stderr[-1500:]}")
    return launches, out


def phase_train_resilient():
    """The port's launcher flow (`repro_torch.launch.train`) at the reduced
    config in a temp dir: the corpus encoded once and saved, reopened
    without re-encoding, a compressed `Checkpointer` every
    RESILIENT_CKPT_EVERY steps, one failure injected at
    RESILIENT_FAIL_AT and recovered by a restore decoded on the card.
    Against an uninterrupted run: the batches after the restart are
    bit-identical and the losses within tolerance; the last checkpoint
    restores bit-equal to the final state (that restore is the
    `checkpoint` path)."""
    import argparse
    import tempfile
    import torch
    from repro_torch.checkpoint.checkpointer import (CheckpointConfig,
                                                     Checkpointer)
    from repro_torch.distributed.fault_tolerance import (
        run_resilient_training)
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    cfg = train_config().reduced()
    model = build_model(cfg)
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                      total_steps=RESILIENT_STEPS)
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        args = argparse.Namespace(
            seq=TRAIN_SEQ, archive=os.path.join(d, "c.acegad"),
            reads=RESILIENT_READS, block=BLOCK, cache_blocks=0,
            device=DEVICE, tune_target=None)
        t0 = time.perf_counter()
        cli.build_archive(args)                 # encode once and save
        encode_s = time.perf_counter() - t0
        ga = cli.build_archive(args)            # reopen: no re-encode

        def run(ckdir, compress, fail_at):
            ds = ga.dataset(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                            prefetch=TRAIN_PREFETCH, seed=SEED)
            state = init_train_state(
                model, torch.Generator(device=DEVICE).manual_seed(SEED), opt)
            ck = Checkpointer(CheckpointConfig(directory=ckdir,
                                               compress=compress))
            inner = make_train_step(model, opt, remat="none")
            seen, toks, losses, failed = [None], {}, {}, []

            def hook(s):
                seen[0] = s
                if s == fail_at and not failed:
                    failed.append(s)
                    raise RuntimeError(f"injected failure at step {s}")

            def step(st, b):
                st, m = inner(st, b)
                toks[seen[0]] = b["tokens"].cpu()
                losses[seen[0]] = float(m["loss"])
                return st, m

            t0 = time.perf_counter()
            final = run_resilient_training(
                step, state, None, ck, n_steps=RESILIENT_STEPS,
                ckpt_every=RESILIENT_CKPT_EVERY, loader=ds, fail_hook=hook,
                log=lambda *a: None)
            return final, ck, toks, losses, failed, time.perf_counter() - t0

        clean, _, toks0, loss0, _, clean_s = run(
            os.path.join(d, "clean"), False, None)
        final, ck, toks1, loss1, failed, run_s = run(
            os.path.join(d, "failing"), True, RESILIENT_FAIL_AT)
        ops.reset_launches()
        t0 = time.perf_counter()
        restored = ck.restore(device=DEVICE)
        restore_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        manifest = restored.pop("_manifest")
    bit_equal = all(
        torch.equal(restored[g][k], final[g][k])
        for g in ("params",) for k in final[g]) and all(
        torch.equal(restored["opt"][m][k], final["opt"][m][k])
        for m in ("m", "v") for k in final["opt"][m]) and torch.equal(
        restored["opt"]["step"], final["opt"]["step"])
    same_batches = sorted(toks0) == sorted(toks1) == list(
        range(RESILIENT_STEPS)) and all(
        torch.equal(toks0[s], toks1[s]) for s in toks0)
    rel = {s: abs(loss1[s] - loss0[s]) / abs(loss0[s]) for s in loss0}
    out = {"phase": "train_resilient", "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "steps": RESILIENT_STEPS, "ckpt_every": RESILIENT_CKPT_EVERY,
           "failed_at": failed, "checkpoint_step": manifest["step"],
           "payload_ratio": manifest.get("payload_ratio"),
           "encode_s": encode_s, "clean_run_s": clean_s,
           "failing_run_s": run_s, "restore_s": restore_s,
           "restored_bit_equal": bit_equal,
           "batches_bit_identical": same_batches,
           "loss_rel_err_max": max(rel.values()),
           "losses_clean": [loss0[s] for s in sorted(loss0)],
           "losses_restarted": [loss1[s] for s in sorted(loss1)],
           "deterministic_algorithms":
               torch.are_deterministic_algorithms_enabled(),
           "launches": launches}
    emit(out)
    if failed != [RESILIENT_FAIL_AT]:
        fail(f"the injected failure did not fire once: {failed}")
    if not bit_equal:
        fail("the restored checkpoint is not the saved state")
    if not same_batches:
        fail("the batches after the restart are not the clean run's")
    if out["loss_rel_err_max"] > 1e-2:
        fail(f"losses after the restart are not the clean run's: {rel}")
    return launches, out


def phase_chaos():
    """The chaos lane on the card: every scenario, prefetch crash
    included."""
    import contextlib
    import io
    from repro_torch.resilience import chaos
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = chaos.main(["--smoke", "--device", DEVICE])
    lines = buf.getvalue().splitlines()
    emit({"phase": "chaos", "rc": rc, "summary": lines[-1] if lines else ""})
    want = f"{len(chaos.SCENARIOS)}/{len(chaos.SCENARIOS)} scenarios passed"
    if rc or not lines or want not in lines[-1]:
        fail(f"chaos smoke on the card: {lines[-6:]}")


def phase_tune(corpus, index):
    """The encode autotuner on the card: the default grid (16 and 64 KiB
    blocks x anchor 0/4 x rANS/raw) swept on the whole records of the
    "ra" corpus's first TUNE_SAMPLE bytes, TUNE_ITERS timings a point,
    once for each target. Every point's ratio must be a CPU encode's of
    its profile; each chosen profile's `GenomicArchive.create` must
    decode the sample bit for bit on the card."""
    from repro_torch.api import GenomicArchive
    from repro_torch.core.encoder import encode
    from repro_torch.kernels import ops
    from repro_torch.tune import autotune
    starts = np.asarray(index.starts, np.int64)
    cut = int(starts[np.searchsorted(starts, TUNE_SAMPLE, "right") - 1])
    sample = corpus[:cut]
    ops.reset_launches()
    sweeps = {}
    for target in ("seek", "ratio", "throughput"):
        t0 = time.perf_counter()
        r = autotune(sample, target=target, sample_bytes=TUNE_SAMPLE,
                     iters=TUNE_ITERS, device=DEVICE)
        sweeps[target] = (r, time.perf_counter() - t0)
    cpu_ratio = {p.profile: encode(sample, profile=p.profile).ratio
                 for p in sweeps["seek"][0].points}
    decoded = {}
    for r, _ in sweeps.values():
        if r.profile not in decoded:
            ga = GenomicArchive.create(sample, profile=r.profile,
                                       device=DEVICE)
            decoded[r.profile] = (ga.profile == r.profile
                                  and ga.store.decoder.decode_all()
                                  .tobytes() == sample)
    launches = dict(ops.LAUNCHES)
    wrong = [(t, p.profile.describe(), p.ratio) for t, (r, _) in
             sweeps.items() for p in r.points
             if p.ratio != cpu_ratio[p.profile]]
    emit({"phase": "tune", "sample_bytes": len(sample),
          "iters": TUNE_ITERS, "sweeps": {
              t: {"sweep_s": s, "chosen": r.profile.describe(),
                  "skipped": [reason for _, reason in r.skipped],
                  "points": [{"profile": p.profile.describe(),
                              "ratio": p.ratio, "seek_us": p.seek_us,
                              "decode_GBps": p.decode_GBps,
                              "on_frontier": p.on_frontier}
                             for p in r.points],
                  "frontier_table": r.table()}
              for t, (r, s) in sweeps.items()},
          "ratio_equals_cpu_encode": not wrong,
          "create_decodes_bit_for_bit": {p.describe(): ok
                                         for p, ok in decoded.items()},
          "launches": launches})
    if wrong:
        fail(f"tune: ratios differ from a CPU encode: {wrong}")
    if not all(decoded.values()):
        fail(f"tune: GenomicArchive.create does not decode the sample: "
             f"{decoded}")
    if any(len(r.points) != 8 for r, _ in sweeps.values()):
        fail("tune: the default grid did not measure 8 points")
    return launches


def _check_contexts(ctx, ids, corpus, starts, width: int, what: str):
    """Each context row must be its read's source bytes (tile and local
    id), cut or zero-padded to `width`."""
    n_reads = starts.size - 1
    got = ctx.cpu().numpy()
    if got.shape != (len(ids), width):
        fail(f"{what}: contexts of shape {got.shape}")
    for row, r in zip(got, ids):
        lr = int(r) % n_reads
        src = np.frombuffer(corpus[starts[lr]:starts[lr + 1]][:width],
                            np.uint8)
        want = np.zeros(width, np.int64)
        want[:src.size] = src
        if not np.array_equal(row, want):
            fail(f"{what}: the context of read {int(r)} is not its bytes")


def phase_serve_model(corpus, index, store):
    """`TRAIN_ARCH` at full width and depth (bf16 weights of a seeded
    init) served by `ServeSession.serve_reads` from the 8 GiB store:
    SERVE_B uniform read ids, SERVE_CTX-byte contexts primed one decode
    step a byte, SERVE_NEW greedy tokens. Per-step device times come from
    CUDA events recorded after each step (no host wait between steps);
    time to first token is the host wall of a call with one new token
    (fetch, the SERVE_CTX-step prime, argmax, the copy to the host),
    once cold and once warm. Two decode steps are profiled. The peak
    device bytes above residency (weights included) are read from after
    the init, whose fp32 temporaries are reported apart."""
    import torch
    from repro_torch.api import GenomicArchive
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.serving import ServeConfig, ServeSession
    starts = np.asarray(index.starts, np.int64)
    ga = GenomicArchive(store)
    cfg = train_config()
    model = build_model(cfg)
    base = _reset_peak()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED + 2))
    sync()
    init_s = time.perf_counter() - t0
    # the init's fp32 temporaries (a 1.5 GB stack) are not serving's
    init_peak = _peak_above(base)
    _reset_peak()
    n_params = sum(v.numel() for v in params.values())
    sess = ServeSession(model, params,
                        ServeConfig(max_seq=SERVE_CTX + SERVE_NEW,
                                    max_new_tokens=SERVE_NEW), store=ga)
    rng = np.random.default_rng(SEED + 2)
    warm_ids, ids = (rng.integers(0, ga.n_reads, SERVE_B) for _ in range(2))
    seen, events = [], []
    generate, decode = sess.generate, sess._decode

    def recording_generate(ctx, n=None):
        seen.append(ctx)
        return generate(ctx, n)

    def timed_decode(*a):
        out = decode(*a)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return out

    sess.generate, sess._decode = recording_generate, timed_decode
    ops.reset_launches()
    ttft_ms = []
    for batch in (warm_ids, ids):
        t0 = time.perf_counter()
        first = sess.serve_reads(batch, SERVE_CTX, 1)
        ttft_ms.append((time.perf_counter() - t0) * 1e3)
    seen.clear()
    events.clear()
    t0 = time.perf_counter()
    toks = sess.serve_reads(ids, SERVE_CTX, SERVE_NEW)
    wall_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    gaps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    prime_ms, step_ms = gaps[:SERVE_CTX - 1], gaps[SERVE_CTX - 1:]
    if len(step_ms) != SERVE_NEW - 1:
        fail(f"serve_model: {len(events)} decode steps timed")
    ctx = seen[0]
    _check_contexts(ctx, ids, corpus, starts, SERVE_CTX,
                    "serve_model")
    sess.generate, sess._decode = generate, decode
    st = sess.prime(ctx)
    cache = st["cache"]
    cur = torch.argmax(st["logits"], dim=-1)[:, None].to(torch.int32)
    if not np.array_equal(cur.cpu().numpy()[:, 0], toks[:, 0]) \
            or not np.array_equal(first[:, 0], toks[:, 0]):
        fail("serve_model: the first token differs between calls")

    def one_step():
        with torch.no_grad():
            model.decode_step(params, cache, cur)

    profiled = _profile_steps(one_step, 2)
    peak = _peak_above(base)
    med = float(np.median(step_ms))
    from repro_torch.roofline import hlo_costs as rl
    roof = _step_roofline(_no_grad(model.decode_step), (params, cache, cur),
                          rl.model_flops_decode(cfg, SERVE_B,
                                                SERVE_CTX + SERVE_NEW),
                          med, "serve_model")
    kv_bytes = sum(cache[k].numel() * cache[k].element_size()
                   for k in ("k", "v"))
    out = {"phase": "serve_model", "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_params": n_params,
           "param_dtype": str(params["embed"].dtype), "init_s": init_s,
           "batch": SERVE_B, "ctx_bytes": SERVE_CTX,
           "new_tokens": SERVE_NEW, "n_reads": ga.n_reads,
           "decode_step_ms_median": med, "decode_step_ms": step_ms,
           "prime_step_ms_median": float(np.median(prime_ms)),
           "tokens_per_s": SERVE_B / (med / 1e3),
           "serve_reads_s": wall_s,
           "serve_reads_tokens_per_s": SERVE_B * SERVE_NEW / wall_s,
           "ttft_ms_cold": ttft_ms[0], "ttft_ms": ttft_ms[1],
           "kv_cache_bytes": kv_bytes,
           "param_bytes": sum(v.numel() * v.element_size()
                              for v in params.values()),
           "init_peak_bytes_above_residency": init_peak,
           "peak_bytes_above_residency": peak, "profile": profiled,
           "roofline": roof,
           "contexts_checked": len(ids), "launches": launches}
    emit(out)
    if toks.shape != (SERVE_B, SERVE_NEW) or not (
            (toks >= 0).all() and (toks < cfg.vocab).all()):
        fail(f"serve_model: tokens {toks.shape} out of range")
    del params, cache, st, sess, model
    torch.cuda.empty_cache()
    return launches, out


def _teacher_forced(model, params, seq, max_seq):
    """Logits of every decode step fed `seq` (B, T), as (T, B, V) fp32 on
    the host."""
    import torch
    cache = model.init_cache(seq.shape[0], max_seq, device=seq.device)
    out = []
    with torch.no_grad():
        for t in range(seq.shape[1]):
            lg, cache = model.decode_step(params, cache, seq[:, t:t + 1])
            out.append(lg.float().cpu())
    return torch.stack(out)


def phase_serve_model_plain(corpus, index, store):
    """The serving slice's card-against-plain check: `TRAIN_ARCH` at full
    width cut to PLAIN_LAYERS layers, the same weights copied to the card
    and to the CPU, `serve_reads` of PLAIN_SERVE["B"] reads from the
    card's store on both. The card is then teacher-forced on the CPU's
    context and tokens: every step's logits within PLAIN_SERVE_TOL
    relative norm of the CPU's."""
    import torch
    from repro_torch.api import GenomicArchive
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.serving import ServeConfig, ServeSession
    B, n_ctx, n_new = PLAIN_SERVE["B"], PLAIN_SERVE["ctx"], PLAIN_SERVE["new"]
    starts = np.asarray(index.starts, np.int64)
    ga = GenomicArchive(store)
    model = build_model(train_config(PLAIN_LAYERS))
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED + 3))
    ids = np.random.default_rng(SEED + 3).integers(0, ga.n_reads, B)
    cfg = ServeConfig(max_seq=n_ctx + n_new, max_new_tokens=n_new)
    ops.reset_launches()
    toks, ctx, secs = {}, {}, {}
    for dev in (DEVICE, "cpu"):
        p = {k: v.to(dev, copy=True) for k, v in params.items()}
        sess = ServeSession(model, p, cfg, store=ga)
        generate = sess.generate
        sess.generate = lambda c, n=None, g=generate, d=dev: (
            ctx.setdefault(d, c), g(c, n))[1]
        t0 = time.perf_counter()
        toks[dev] = sess.serve_reads(ids, n_ctx)
        secs[dev] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    _check_contexts(ctx["cpu"], ids, corpus, starts, n_ctx,
                    "serve_model_plain")
    if not torch.equal(ctx[DEVICE].cpu(), ctx["cpu"]):
        fail("serve_model_plain: the card's contexts are not the CPU's")
    seq = torch.cat([ctx["cpu"], torch.from_numpy(toks["cpu"][:, :-1])], 1)
    want = _teacher_forced(model, {k: v.to("cpu", copy=True)
                                   for k, v in params.items()},
                           seq, cfg.max_seq)
    got = _teacher_forced(model, params, seq.to(DEVICE), cfg.max_seq)
    rel = [float((g.double() - w.double()).norm() / w.double().norm())
           for g, w in zip(got, want)]
    greedy = want[n_ctx - 1:].argmax(-1).T.numpy()
    out = {"phase": "serve_model_plain", "n_layers": PLAIN_LAYERS,
           "batch": B, "ctx_bytes": n_ctx, "new_tokens": n_new,
           "logits_rel_err_max": max(rel),
           "logits_rel_err_generated": rel[n_ctx - 1:],
           "tokens_equal_share": float((toks[DEVICE] == toks["cpu"]).mean()),
           "card_s": secs[DEVICE], "plain_s": secs["cpu"],
           "tolerance": PLAIN_SERVE_TOL, "launches": launches}
    emit(out)
    if not np.array_equal(greedy, toks["cpu"]):
        fail("serve_model_plain: the CPU's tokens are not its greedy ones")
    if not max(rel) <= PLAIN_SERVE_TOL:
        fail(f"serve_model_plain: the card's logits are not the plain "
             f"path's: {out}")
    del params
    torch.cuda.empty_cache()
    return launches, out


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def start_examples() -> dict:
    """The port's four examples (`examples/*_torch.py`), each in a
    process of its own on the card, all started together, their output
    to files under build/examples (no pipe to fill while the plain
    families and the roofline phase run); collected by
    `phase_examples`."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out_dir = os.path.join(ROOT, "build", "examples")
    os.makedirs(out_dir, exist_ok=True)
    procs, files = {}, {}
    for n, flags in EXAMPLES.items():
        files[n] = tuple(open(os.path.join(out_dir, f"{n}.{x}"), "w+")
                         for x in ("out", "err"))
        procs[n] = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples", f"{n}_torch.py"),
             "--device", DEVICE, *flags], cwd=ROOT, env=env,
            stdout=files[n][0], stderr=files[n][1], text=True)
    return {"t0": time.perf_counter(), "procs": procs, "files": files}


def phase_examples(started: dict) -> dict:
    """Waits for the examples `start_examples` started: each must exit 0
    and end with its JSON line of `ops.LAUNCHES`, its own process's
    launches of both kernels, which become the path `example_<name>`.
    Prints the phase's wall time and the wait it added here."""
    t_wait = time.perf_counter()
    procs, outs = started["procs"], {}
    try:
        for p in procs.values():
            p.wait(timeout=EXAMPLES_TIMEOUT_S)
    finally:
        _stop(procs.values())
    t_end = time.perf_counter()
    for n, fs in started["files"].items():
        outs[n] = []
        for f in fs:
            f.seek(0)
            outs[n].append(f.read())
            f.close()
    paths, lines = {}, {}
    for n, p in procs.items():
        stdout, stderr = outs[n]
        tail = stdout.splitlines()[-1:] or [""]
        try:
            last = json.loads(tail[0])
        except ValueError:
            last = {}
        if p.returncode or "launches" not in last:
            fail(f"example {n}: rc {p.returncode}: {stdout[-1500:]} "
                 f"{stderr[-1500:]}")
        paths[f"example_{n}"] = last["launches"]
        lines[n] = stdout.splitlines()[-6:-1]
    emit({"phase": "examples", "wall_s": t_end - started["t0"],
          "wait_s": t_end - t_wait, "launches": paths, "tails": lines})
    return paths


def phase_serve_launcher():
    """`python -m repro_torch.launch.serve` with its defaults (reduced
    config, on the card) in a process of its own."""
    import torch
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    lines = res.stdout.splitlines()
    tuned = [ln for ln in lines if ln.startswith("tuned profile")]
    tok_s = [ln for ln in lines
             if f"tok/s on {torch.cuda.get_device_name(0)})" in ln]
    emit({"phase": "serve_launcher", "rc": res.returncode,
          "s": time.perf_counter() - t0, "tuned": tuned, "tok_s": tok_s,
          "stderr_tail": res.stderr[-600:] if res.returncode else ""})
    if res.returncode or not tuned or not tok_s:
        fail(f"serve launcher: rc {res.returncode}: {lines[-6:]} "
             f"{res.stderr[-1500:]}")


def family_config(arch: str, n_layers=None):
    """`arch` as published, or cut to `n_layers` layers (whisper: that
    many encoder and decoder layers), widths unchanged."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if n_layers is None:
        return cfg
    enc = {"n_enc_layers": n_layers} if cfg.family == "whisper" else {}
    return dataclasses.replace(cfg, n_layers=n_layers, **enc)


def family_inputs(cfg, B: int, seed: int) -> dict:
    """The inputs a family's batch needs beyond tokens and labels, drawn
    on the card from a seeded generator: whisper's frames (B, 1500,
    d_model); the VLM's image embeddings over its first n_img_tokens
    positions (its M-RoPE ids are the text-only default)."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    if cfg.family == "whisper":
        return {"frames": torch.randn((B, cfg.n_frames, cfg.d_model),
                                      generator=g, device=DEVICE)}
    if cfg.family == "vlm":
        return {"img_embeds": torch.randn(
            (B, cfg.n_img_tokens, cfg.d_model), generator=g, device=DEVICE)}
    return {}


def _n_params(params) -> int:
    return sum(v.numel() for v in params.values())


def _train_family(arch, spec, ga, corpus, starts, smi):
    """FAMILY_STEPS train steps of `arch` from the 8 GiB store."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    seq, remat = spec["seq"], spec.get("remat", "none")
    cfg = family_config(arch, spec.get("train_layers"))
    model = build_model(cfg)
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=FAMILY_STEPS)
    base = _reset_peak()
    state = init_train_state(
        model, torch.Generator(device=DEVICE).manual_seed(SEED), opt)
    n_params = _n_params(state["params"])
    extra = family_inputs(cfg, FAMILY_BATCH, SEED)
    ds = ga.dataset(batch_size=FAMILY_BATCH, seq_len=seq,
                    prefetch=TRAIN_PREFETCH, seed=SEED)
    step = make_train_step(model, opt, remat=remat)
    ops.reset_launches()
    it = iter(ds)
    losses, step_ms, seen = [], [], []
    for i in range(FAMILY_STEPS):
        b = next(it)
        t0 = time.perf_counter()
        state, m = step(state, {**b, **extra})
        losses.append(float(m["loss"]))   # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        seen.append((b, ds.sampler.sample(i)))
    pf = ds.prefetch_stats()
    ds.close()
    launches = dict(ops.LAUNCHES)
    peak = _peak_above(base)
    for n, (b, ids) in enumerate(seen):
        _check_tokens(b, ids, corpus, starts, f"{arch} batch {n}", seq)
    med = float(np.median(step_ms[1:]))
    from repro_torch.roofline import hlo_costs as rl
    roof = _step_roofline(step, (state, {**seen[0][0], **extra}),
                          rl.model_flops_train(cfg, FAMILY_BATCH * seq),
                          med, f"{arch} train")
    out = {"arch": arch, "family": cfg.family, "n_layers": cfg.n_layers,
           "n_enc_layers": cfg.n_enc_layers, "d_model": cfg.d_model,
           "n_params": n_params, "param_dtype": "bfloat16", "remat": remat,
           "batch": FAMILY_BATCH, "seq_len": seq,
           "extra_inputs": sorted(extra), "losses": losses,
           "step_ms": step_ms, "step_ms_median": med,
           "tokens_per_s": FAMILY_BATCH * seq / (med / 1e3),
           "peak_bytes_above_residency": peak,
           "prefetch": pf, "roofline": roof, "launches": launches,
           "nvidia_smi": smi}
    if not all(np.isfinite(losses)):
        fail(f"{arch}: a train loss is not finite: {losses}")
    del state, model, extra, seen
    torch.cuda.empty_cache()
    return out


def _serve_family(arch, spec, ga, corpus, starts, smi):
    """`arch` served by `ServeSession.serve_reads` from the 8 GiB store:
    a one-token call on SERVE_B warm-up ids, time to first token on
    SERVE_B fresh ids, then SERVE_NEW tokens with per-step CUDA events
    (the prime's SERVE_CTX steps and the generated steps apart)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.serving import ServeConfig, ServeSession
    cfg = family_config(arch, spec.get("serve_layers"))
    model = build_model(cfg)
    base = _reset_peak()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED + 2))
    sync()
    init_peak = _peak_above(base)
    _reset_peak()
    sess = ServeSession(model, params,
                        ServeConfig(max_seq=SERVE_CTX + SERVE_NEW,
                                    max_new_tokens=SERVE_NEW), store=ga)
    rng = np.random.default_rng(SEED + 2)
    warm_ids, ids = (rng.integers(0, ga.n_reads, SERVE_B) for _ in range(2))
    seen, events = [], []
    generate, decode = sess.generate, sess._decode

    def recording_generate(ctx, n=None):
        seen.append(ctx)
        return generate(ctx, n)

    def timed_decode(*a):
        out = decode(*a)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return out

    sess.generate, sess._decode = recording_generate, timed_decode
    ops.reset_launches()
    sess.serve_reads(warm_ids, SERVE_CTX, 1)
    t0 = time.perf_counter()
    first = sess.serve_reads(ids, SERVE_CTX, 1)
    ttft_ms = (time.perf_counter() - t0) * 1e3
    seen.clear()
    events.clear()
    t0 = time.perf_counter()
    toks = sess.serve_reads(ids, SERVE_CTX, SERVE_NEW)
    wall_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = _peak_above(base)
    gaps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    prime_ms, step_ms = gaps[:SERVE_CTX - 1], gaps[SERVE_CTX - 1:]
    if len(step_ms) != SERVE_NEW - 1:
        fail(f"{arch} serve: {len(events)} decode steps timed")
    _check_contexts(seen[0], ids, corpus, starts, SERVE_CTX, f"{arch} serve")
    if toks.shape != (SERVE_B, SERVE_NEW) or not (
            (toks >= 0).all() and (toks < cfg.vocab).all()):
        fail(f"{arch} serve: tokens {toks.shape} out of range")
    if not np.array_equal(first[:, 0], toks[:, 0]):
        fail(f"{arch} serve: the first token differs between calls")
    cache_bytes = sum(t.numel() * t.element_size() for t in
                      model.cache_specs(SERVE_B, SERVE_CTX + SERVE_NEW)
                      .values())
    med = float(np.median(step_ms))
    # the decode step counted on a fresh cache of the served size (FLOPs
    # and bytes depend on shapes only)
    from repro_torch.roofline import hlo_costs as rl
    slots = SERVE_CTX + SERVE_NEW
    cache = model.init_cache(SERVE_B, slots, device=DEVICE)
    cur = torch.zeros((SERVE_B, 1), dtype=torch.int32, device=DEVICE)
    roof = _step_roofline(_no_grad(model.decode_step), (params, cache, cur),
                          rl.model_flops_decode(cfg, SERVE_B, slots), med,
                          f"{arch} serve")
    del cache
    out = {"arch": arch, "n_layers": cfg.n_layers,
           "n_enc_layers": cfg.n_enc_layers, "n_params": _n_params(params),
           "batch": SERVE_B, "ctx_bytes": SERVE_CTX,
           "new_tokens": SERVE_NEW, "decode_step_ms_median": med,
           "decode_step_ms": step_ms,
           "prime_step_ms_median": float(np.median(prime_ms)),
           "tokens_per_s": SERVE_B / (med / 1e3), "ttft_ms": ttft_ms,
           "serve_reads_s": wall_s, "cache_bytes": cache_bytes,
           "init_peak_bytes_above_residency": init_peak,
           "peak_bytes_above_residency": peak, "roofline": roof,
           "launches": launches, "nvidia_smi": smi}
    del params, sess, model
    torch.cuda.empty_cache()
    return out


def phase_families(corpus, index, store, smi):
    """Each config of FAMILIES at its published widths (depth cut where
    FAMILIES says), bf16 weights of a seeded init: FAMILY_STEPS train
    steps from the 8 GiB store through `GenomicArchive.dataset` (the
    prefetch worker on its own stream; whisper's frames and the VLM's
    image embeddings drawn on the card from a seed; every batch checked
    against its reads), then served by `ServeSession.serve_reads` from
    the same store. Every path must launch both kernels."""
    from repro_torch.api import GenomicArchive
    starts = np.asarray(index.starts, np.int64)
    ga = GenomicArchive(store)
    paths, results = {}, {}
    for arch, spec in FAMILIES.items():
        t0 = time.perf_counter()
        train = _train_family(arch, spec, ga, corpus, starts, smi)
        serve = _serve_family(arch, spec, ga, corpus, starts, smi)
        out = {"phase": "family", "arch": arch, "train": train,
               "serve": serve, "s": time.perf_counter() - t0}
        emit(out)
        paths[f"train:{arch}"] = train["launches"]
        paths[f"serve:{arch}"] = serve["launches"]
        results[arch] = out
    _check_launched(paths)
    return paths, results


def _check_launched(paths) -> None:
    """Both kernels must have run on every path."""
    for path, counts in paths.items():
        for k, n in counts.items():
            if not n:
                fail(f"{k} was not launched on the {path} path")


def _plain_rel(want, got) -> float:
    """Relative norm of got - want (fp32 norms: the MoE's expert leaves
    are 1.6e9 elements, too large to copy to fp64 beside the state)."""
    den = float(want.norm())
    return float((got - want).norm()) / den if den else float(got.norm())


def _plain_family(arch, ga, corpus, starts):
    """One family at PLAIN_FAMILY_LAYERS layers, fp32, card against CPU:
    the loss, gradient norm and every leaf's gradient of one record
    (with the family's inputs), then `serve_reads` on both from the
    card's store and the card teacher-forced on the CPU's sequence."""
    import functools
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.serving import ServeConfig, ServeSession
    from repro_torch.training.optimizer import global_norm
    seq = FAMILIES[arch]["seq"]
    cfg = family_config(arch, PLAIN_FAMILY_LAYERS[get_config(arch).family])
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED + 4),
                        torch.float32)
    cpu_params = {k: v.to("cpu", copy=True) for k, v in params.items()}
    ops.reset_launches()
    batch = ga.dataset(batch_size=1, seq_len=seq, prefetch=0,
                       seed=SEED + 4).batch_at(0)
    batch.update(family_inputs(cfg, 1, SEED + 4))
    train_launches = dict(ops.LAUNCHES)
    got = {}
    for dev, p in ((DEVICE, params), ("cpu", cpu_params)):
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        b = {k: v.to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        loss = model.loss(leaves, b, remat="none")
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        got[dev] = (loss.item(), float(global_norm(grads)),
                    time.perf_counter() - t0, grads)
        for v in p.values():
            v.requires_grad_(False)
        del leaves, loss
    (lc, gc, tc, grc), (lp, gp, tp, grp) = got[DEVICE], got["cpu"]
    del got
    # leaf by leaf, each freed as it is read: the MoE's fp32 weights and
    # gradients take 50 GB of the card at 2 layers
    leaf_err = {}
    for k in sorted(grp):
        leaf_err[k] = _plain_rel(grp[k].to(DEVICE), grc[k])
        grp[k] = grc[k] = None
    del grc, grp
    worst = max((k for k in leaf_err if k != "embed"), key=leaf_err.get)
    # serving, fp32 weights and an fp32 cache on both
    B, n_ctx, n_new = (PLAIN_FAMILY_SERVE[k] for k in ("B", "ctx", "new"))
    model.init_cache = functools.partial(type(model).init_cache, model,
                                         dtype=torch.float32)
    ids = np.random.default_rng(SEED + 4).integers(0, ga.n_reads, B)
    scfg = ServeConfig(max_seq=n_ctx + n_new, max_new_tokens=n_new)
    toks, ctx = {}, {}
    ops.reset_launches()
    for dev, p in ((DEVICE, params), ("cpu", cpu_params)):
        sess = ServeSession(model, p, scfg, store=ga)
        generate = sess.generate
        sess.generate = lambda c, n=None, g=generate, d=dev: (
            ctx.setdefault(d, c), g(c, n))[1]
        toks[dev] = sess.serve_reads(ids, n_ctx)
    serve_launches = dict(ops.LAUNCHES)
    _check_contexts(ctx["cpu"], ids, corpus, starts, n_ctx,
                    f"{arch} plain serve")
    seq_t = torch.cat([ctx["cpu"], torch.from_numpy(toks["cpu"][:, :-1])], 1)
    want = _teacher_forced(model, cpu_params, seq_t, scfg.max_seq)
    got_l = _teacher_forced(model, params, seq_t.to(DEVICE), scfg.max_seq)
    rel = [_plain_rel(w, g) for g, w in zip(got_l, want)]
    greedy = want[n_ctx - 1:].argmax(-1).T.numpy()
    out = {"arch": arch, "n_layers": cfg.n_layers,
           "n_enc_layers": cfg.n_enc_layers, "dtype": "float32",
           "batch": 1, "seq_len": seq, "loss_card": lc, "loss_plain": lp,
           "loss_rel_err": abs(lc - lp) / abs(lp),
           "grad_norm_card": gc, "grad_norm_plain": gp,
           "grad_norm_rel_err": abs(gc - gp) / abs(gp),
           "grad_embed_rel_err": leaf_err["embed"],
           "grad_leaf_rel_err_max": leaf_err[worst],
           "grad_leaf_worst": worst, "card_s": tc, "plain_s": tp,
           "serve_batch": B, "ctx_bytes": n_ctx, "new_tokens": n_new,
           "logits_rel_err_max": max(rel),
           "tokens_equal": bool(np.array_equal(toks[DEVICE], toks["cpu"])),
           "train_launches": train_launches,
           "serve_launches": serve_launches}
    emit({"phase": "family_plain", **out})
    del params, cpu_params, model
    torch.cuda.empty_cache()
    bad = [k for k, e in leaf_err.items() if not e <= PLAIN_FAMILY_TOL[
        "grad_embed" if k == "embed" else "grad"]]
    if not (out["loss_rel_err"] <= PLAIN_FAMILY_TOL["loss"]
            and out["grad_norm_rel_err"] <= PLAIN_FAMILY_TOL["grad_norm"]) \
            or bad:
        fail(f"families_plain {arch}: the card's loss or gradients are not "
             f"the plain path's (leaves past the bound: {bad}): {out}")
    if not np.array_equal(greedy, toks["cpu"]):
        fail(f"families_plain {arch}: the CPU's tokens are not its greedy "
             f"ones")
    if not (out["tokens_equal"]
            and out["logits_rel_err_max"] <= PLAIN_FAMILY_TOL["logits"]):
        fail(f"families_plain {arch}: the card's serving is not the plain "
             f"path's: {out}")
    return out


def phase_families_plain(corpus, index, store):
    """Card against plain path for every family of FAMILIES (see
    PLAIN_FAMILY_LAYERS), within PLAIN_FAMILY_TOL."""
    import torch
    from repro_torch.api import GenomicArchive
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for fp32 matmuls; the plain check needs it off")
    starts = np.asarray(index.starts, np.int64)
    ga = GenomicArchive(store)
    paths, results = {}, {}
    for arch in FAMILIES:
        out = _plain_family(arch, ga, corpus, starts)
        paths[f"plain_train:{arch}"] = out["train_launches"]
        paths[f"plain_serve:{arch}"] = out["serve_launches"]
        results[arch] = out
    emit({"phase": "families_plain", "tolerance": PLAIN_FAMILY_TOL,
          "families": sorted(results)})
    _check_launched(paths)
    return paths, results


def phase_roofline(train, served, families, smi):
    """The dry-run where there is no JAX: `python -m
    repro_torch.launch.dryrun` for each runnable shape of ROOFLINE_ARCH
    on the ROOFLINE_MESH production mesh (meta tensors over a fake world
    of 256 ranks), one process a shape, all started together; then
    `python -m repro_torch.roofline.report` on their records. Every cell
    must be ok. Prints the measured steps' roofline numbers together."""
    import glob
    import shutil
    from repro_torch.configs import get_config
    out_dir = os.path.join(ROOT, "build", "roofline")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    shapes = [s.name for s in get_config(ROOFLINE_ARCH).runnable_shapes()]
    t0 = time.perf_counter()
    procs = {s: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         ROOFLINE_ARCH, "--shape", s, "--mesh", ROOFLINE_MESH, "--out",
         os.path.join(out_dir, f"dryrun_{s}.json")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s in shapes}
    logs = {}
    try:
        for s, p in procs.items():
            logs[s] = p.communicate(timeout=ROOFLINE_TIMEOUT_S)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    dryrun_s = time.perf_counter() - t0
    for s, p in procs.items():
        if p.returncode != 0:
            fail(f"roofline: the dry-run of {ROOFLINE_ARCH} {s} exited "
                 f"{p.returncode}: {logs[s][-2000:]}")
    rep_out = subprocess.run(
        [sys.executable, "-m", "repro_torch.roofline.report",
         *sorted(glob.glob(os.path.join(out_dir, "dryrun_*.json")))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    want = f"# {len(shapes)}/{len(shapes)} cells ok"
    if rep_out.returncode != 0 or want not in rep_out.stdout:
        fail(f"roofline: report: {rep_out.stdout[-2000:]}"
             f"{rep_out.stderr[-2000:]}")
    records = []
    for f in sorted(glob.glob(os.path.join(out_dir, "dryrun_*.json"))):
        with open(f) as fh:
            records.extend(json.load(fh))
    held = _hold_dryrun(records)
    steps = {"train": train["roofline"], "serve_model": served["roofline"]}
    for a, r in families.items():
        steps[f"train:{a}"] = r["train"]["roofline"]
        steps[f"serve:{a}"] = r["serve"]["roofline"]
    out = {"phase": "roofline", "nvidia_smi": smi,
           "peak_flops": steps["train"]["peak_flops"],
           "hbm_bw": steps["train"]["hbm_bw"],
           "steps": {k: {f: v[f] for f in (
               "model_flops", "counted_flops", "counted_bytes", "step_ms",
               "mfu", "roofline_ms", "roofline_share", "bound_by")}
               for k, v in steps.items()},
           "memory": train["memory"],
           "dryrun": {"arch": ROOFLINE_ARCH, "mesh": ROOFLINE_MESH,
                      "wall_s": dryrun_s,
                      "cells": [{k: r.get(k) for k in (
                          "shape", "ok", "compile_s", "memory_analysis",
                          "flops_per_device", "bytes_per_device",
                          "coll_bytes_per_device", "dominant",
                          "step_time_s", "roofline_fraction",
                          "model_flops", "fallbacks")} for r in records],
                      "held": held},
           "report": rep_out.stdout}
    emit(out)
    return out


def _hold_dryrun(records) -> dict:
    """What the dry-run must read on this machine's PyTorch: train_4k's
    counted FLOPs x cards within ROOFLINE_FLOPS_RATIO of its model FLOPs
    and its temp below ROOFLINE_TEMP_MAX, its collective bytes within
    ROOFLINE_COLLECTIVE_BYTES; in train_4k and prefill_32k
    the replicate fallbacks at most ROOFLINE_REPLICATE_SHARE of the
    collective bytes. Prints the readings; fails otherwise."""
    import torch
    by = {r["shape"]: r for r in records}
    held = {"torch": torch.__version__}
    for s in ("train_4k", "prefill_32k"):
        r = by[s]
        coll = sum(r["coll_bytes_per_device"].values())
        held[s] = {"replicate_share":
                   r["fallbacks"]["replicate"]["bytes"] / coll if coll else 0.0,
                   "fallbacks": {k: f["count"] for k, f in
                                 r["fallbacks"].items() if f["count"]}}
    train = by["train_4k"]
    held["train_4k"]["flops_ratio"] = (train["flops_per_device"]
                                       * train["n_devices"]
                                       / train["model_flops"])
    held["train_4k"]["temp_size_in_bytes"] = \
        train["memory_analysis"]["temp_size_in_bytes"]
    held["train_4k"]["coll_bytes_per_device"] = \
        train["coll_bytes_per_device"]
    print(f"dryrun on torch {held['torch']}: {json.dumps(held)}", flush=True)
    lo, hi = ROOFLINE_FLOPS_RATIO
    if not lo <= held["train_4k"]["flops_ratio"] <= hi:
        fail(f"roofline: train_4k FLOPs x cards / model FLOPs "
             f"{held['train_4k']['flops_ratio']:.3f} outside {lo}-{hi}")
    for s in ("train_4k", "prefill_32k"):
        if held[s]["replicate_share"] > ROOFLINE_REPLICATE_SHARE:
            fail(f"roofline: {s}'s replicate fallbacks carry "
                 f"{held[s]['replicate_share']:.3f} of its collective "
                 f"bytes (at most {ROOFLINE_REPLICATE_SHARE})")
    coll = sum(train["coll_bytes_per_device"].values())
    lo, hi = ROOFLINE_COLLECTIVE_BYTES
    if not lo <= coll <= hi:
        fail(f"roofline: train_4k collective bytes a card {coll:.4e} "
             f"outside {lo:.1e}-{hi:.1e}")
    if held["train_4k"]["temp_size_in_bytes"] >= ROOFLINE_TEMP_MAX:
        fail(f"roofline: train_4k temp "
             f"{held['train_4k']['temp_size_in_bytes']:.4e} B, not below "
             f"{ROOFLINE_TEMP_MAX:.0e}")
    return held


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card: this smoke runs the port on the GPU only")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    t_start = time.perf_counter()
    # daemonic workers: they end with the smoke if it fails before
    # phase_global takes their archives
    pool, encodes = start_encodes()
    smi = phase_device()
    small_err = phase_kernels_vs_plain()
    corpus, index, store, tiled, a16 = phase_resident(encodes)
    paths = {}
    paths["decode"], dec_calls = phase_decode(corpus, store)
    paths["fetch"], fetch_calls = phase_fetch(corpus, index, store)
    timing = phase_timing(store)
    profile = phase_profile(store, a16)
    paths["global"], window = phase_global(pool, encodes)
    paths["mode1"] = phase_mode1(corpus, index, store)
    paths["stream"] = phase_stream(corpus, store)
    paths["cache"] = phase_cache(corpus, index, tiled)
    paths["heal"], heal_store, xor_wall_ms = phase_heal(corpus, index, a16)
    paths["partial"] = phase_partial(corpus, index, heal_store)
    del heal_store
    paths["serve"] = phase_serve(corpus, index, tiled)
    paths["shard"], shard = phase_shard(corpus, index, store)
    paths["train"], train = phase_train(corpus, index, store)
    plain = phase_train_plain(store)
    paths["train_dp"], dp = phase_train_dp(corpus, index, store)
    paths["checkpoint"], resilient = phase_train_resilient()
    phase_chaos()
    paths["tune"] = phase_tune(corpus, index)
    paths["serve_model"], served = phase_serve_model(corpus, index, store)
    paths["serve_model_plain"], served_plain = phase_serve_model_plain(
        corpus, index, store)
    phase_serve_launcher()
    fam_paths, families = phase_families(corpus, index, store, smi)
    # the examples run on the card in their own processes while the
    # plain families (CPU references of tiny card steps) and the dry-run
    # (host work on meta tensors) run
    examples = start_examples()
    try:
        plain_paths, fam_plain = phase_families_plain(corpus, index, store)
        roofline = phase_roofline(train, served, families, smi)
    except BaseException:
        _stop(examples["procs"].values())
        raise
    ex_paths = phase_examples(examples)
    paths.update(fam_paths)
    paths.update(plain_paths)
    paths.update(ex_paths)
    # the paths each kernel runs on, and those it must not
    both = ("stream", "cache", "heal", "partial", "serve", "shard", "train",
            "train_dp", "checkpoint", "tune", "serve_model",
            "serve_model_plain", *fam_paths, *plain_paths, *ex_paths)
    runs_on = {"rans_decode": ("decode", "fetch", "global", *both),
               "lz77_match": ("decode", "fetch", "mode1", *both)}
    for k, on in runs_on.items():
        for path, counts in paths.items():
            if (path in on) != bool(counts[k]):
                fail(f"{k} launched {counts[k]} times on the {path} path")
    emit({"phase": "summary", "elapsed_s": time.perf_counter() - t_start,
          "global_resolve_ms_per_window": window["resolve_ms_per_window"],
          "global_resolve_share": window["resolve_share_of_device"],
          "xor_rebuild_device_ms": profile["xor_rebuild"]["device_busy_ms"],
          "xor_rebuild_wall_ms": xor_wall_ms,
          "train_step_ms_median": train["step_ms_median"],
          "train_tokens_per_s": train["tokens_per_s"],
          "train_peak_bytes_above_residency":
              train["peak_bytes_above_residency"],
          "train_plain_loss_rel_err": plain["loss_rel_err"],
          "train_plain_grad_norm_rel_err": plain["grad_norm_rel_err"],
          "train_plain_grad_leaf_rel_err_max":
              plain["grad_leaf_rel_err"][plain["grad_leaf_worst"]],
          "train_resilient_loss_rel_err_max":
              resilient["loss_rel_err_max"],
          "serve_decode_step_ms_median": served["decode_step_ms_median"],
          "serve_tokens_per_s": served["tokens_per_s"],
          "serve_ttft_ms": served["ttft_ms"],
          "serve_peak_bytes_above_residency":
              served["peak_bytes_above_residency"],
          "serve_plain_logits_rel_err_max":
              served_plain["logits_rel_err_max"],
          "shard_per_shard_over_flat": shard["per_shard_over_flat"],
          "shard_b1_p50_ms": shard["b1_p50_ms"],
          "shard_b256_reads_per_s": shard["b256_reads_per_s"],
          "shard_stream_GBps": shard["stream"]["GBps"],
          "shard_cache_hit_rate_steady": shard["cache"]["steady"]["hit_rate"],
          "shard_heal_and_rebuild_ms": shard["heal"]["heal_and_rebuild_ms"],
          "train_dp_step_ms_median": dp["full"]["fp"]["step_ms_median"],
          "train_dp_int8_step_ms_median":
              dp["full"]["int8"]["step_ms_median"],
          "train_dp_grad_err_over_quantum_max":
              dp["grad_err_over_quantum_max"],
          "families": {a: {
              "train_step_ms_median": r["train"]["step_ms_median"],
              "train_tokens_per_s": r["train"]["tokens_per_s"],
              "train_peak_bytes_above_residency":
                  r["train"]["peak_bytes_above_residency"],
              "decode_step_ms_median": r["serve"]["decode_step_ms_median"],
              "serve_tokens_per_s": r["serve"]["tokens_per_s"],
              "ttft_ms": r["serve"]["ttft_ms"],
              "serve_peak_bytes_above_residency":
                  r["serve"]["peak_bytes_above_residency"],
              "plain_loss_rel_err": fam_plain[a]["loss_rel_err"],
              "plain_grad_norm_rel_err": fam_plain[a]["grad_norm_rel_err"],
              "plain_grad_leaf_rel_err_max":
                  fam_plain[a]["grad_leaf_rel_err_max"],
              "plain_logits_rel_err_max": fam_plain[a]["logits_rel_err_max"]}
              for a, r in families.items()},
          "mfu": {k: v["mfu"] for k, v in roofline["steps"].items()},
          "roofline_share": {k: v["roofline_share"]
                             for k, v in roofline["steps"].items()},
          "state_allocated_over_reckoned":
              roofline["memory"]["allocated_over_reckoned"],
          "dryrun_wall_s": roofline["dryrun"]["wall_s"],
          "dryrun_held": roofline["dryrun"]["held"]})
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
         "bound_by": timing[k]["bound_by"], "library_ms": None,
         "profile_tries": PROFILE_TRIES[f"{k}_kernel"]}
        for k in ("rans_decode", "lz77_match")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
