#!/usr/bin/env python3
"""Phase clocks and kernel times of the port's `lz77_match` CUDA kernel.

    python3 scripts/lz77_phase_clocks.py [SOURCE.cu ...]

Needs one NVIDIA card and nvcc. Each SOURCE (default: the checkout's
`src/repro_torch/csrc/lz77_match.cu`; a variant of it to compare against)
is built twice, as is and with -DLZ77_PHASE_CLOCKS, all `nvcc` at once,
into the checkout's git-ignored `build/kernels/phase_clocks/`.

The input is the one `chip_smoke.py`'s timing phase uses: its 16 MiB
corpus of 16 KiB blocks (seed 12), tiled to one 4096-block decode chunk,
and the chunk's largest depth bucket at that bucket's rounds. For each
source the script checks the kernel's bytes against the plain version
(both builds, at the bucket's rounds and at 0 rounds), times the wrapper
call by CUDA events over 20 back-to-back launches at both round counts,
in passes that alternate between the sources, and reads from the
instrumented build the mean SM clock cycles a CTA spends in each phase
(prologue, fill, rounds, payout; each phase ends at a barrier). One JSON
line per source, after the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as smoke  # noqa: E402  (shapes, timers, nvidia-smi line)

PHASES = ("prologue", "fill", "rounds", "payout")
PASSES = 5          # timing passes, each over every source in turn
CLOCK_LAUNCHES = 5  # launches averaged into the phase clocks


def build(sources):
    """{(source, instrumented): loaded library}, every nvcc started first."""
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "phase_clocks"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, src in enumerate(sources):
        for clocks in (False, True):
            lib = out_dir / f"lz77_{i}{'_clocks' if clocks else ''}.so"
            flags = ("-DLZ77_PHASE_CLOCKS",) if clocks else ()
            jobs.append((src, clocks, lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
                 src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    libs = {}
    for src, clocks, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            smoke.fail(f"nvcc failed for {src} (clocks={clocks}):\n{log}")
        libs[src, clocks] = ctypes.CDLL(str(lib))
    return libs


def chunk_bucket():
    """Match-kernel arguments of the first decode chunk's largest depth
    bucket, and that bucket's rounds, as `chip_smoke.phase_timing` takes
    them."""
    import torch
    from repro_torch.core import decoder as dec
    from repro_torch.core.encoder import encode
    from repro_torch.data.tiling import aligned_fastq, tile_archive
    corpus = aligned_fastq(smoke.CORPUS_BLOCKS, smoke.BLOCK, seed=smoke.SEED)
    tiled = tile_archive(encode(corpus, block_size=smoke.BLOCK),
                         smoke.CHUNK // smoke.CORPUS_BLOCKS)
    d = dec.Decoder(tiled, device=smoke.DEVICE)
    sel_np = np.arange(smoke.CHUNK)
    groups = d._ra_groups(sel_np) or [(d.da.max_depth, sel_np)]
    rounds, idx = max(groups, key=lambda g: g[1].size)
    gsel = torch.from_numpy(sel_np[idx]).to(d.device)
    return dec._match_inputs(d.da, dec._entropy_decode_sel(d.da, gsel),
                             gsel), int(rounds)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        smoke.fail("no CUDA card: the phase clocks run on the GPU only")
    sources = [os.path.abspath(s) for s in sys.argv[1:]] or [
        os.path.join(ROOT, "src", "repro_torch", "csrc", "lz77_match.cu")]
    print(smoke.nvidia_smi(), flush=True)
    from repro_torch.kernels import _build, ops, ref
    libs = build(sources)
    m, rounds = chunk_bucket()
    round_counts = (rounds, 0)
    want = {r: ref.lz77_decode_planes_ref(**m, n_rounds=r)
            for r in round_counts}

    def launch(r):
        return ops.lz77_decode_planes(**m, n_rounds=r)

    def use(src, clocks):
        _build._libs["lz77_match"] = libs[src, clocks]

    for src, clocks in libs:
        use(src, clocks)
        for r in round_counts:
            if not torch.equal(launch(r), want[r]):
                smoke.fail(f"{src} (clocks={clocks}) differs from the plain "
                           f"version at {r} rounds")
    ms = {s: {r: [] for r in round_counts} for s in sources}
    for _ in range(PASSES):
        for s in sources:
            use(s, False)
            for r in round_counts:
                ms[s][r].append(smoke.time_ms(lambda: launch(r), 20))
    for s in sources:
        use(s, True)
        read = libs[s, True].lz77_phase_clocks
        read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
        slots = (ctypes.c_ulonglong * 5)()
        cycles = {}
        for r in round_counts:
            torch.cuda.synchronize()
            if read(slots):                       # zero the slots
                smoke.fail("reading the phase clocks failed")
            for _ in range(CLOCK_LAUNCHES):
                launch(r)
            torch.cuda.synchronize()
            if read(slots):
                smoke.fail("reading the phase clocks failed")
            ctas = slots[4]
            cycles[r] = {"ctas": ctas, **{p: slots[i] / ctas
                                           for i, p in enumerate(PHASES)}}
        smoke.emit({"source": os.path.relpath(s, ROOT),
                    "blocks": int(m["n_cmds"].shape[0]), "rounds": rounds,
                    "ms": ms[s][rounds], "ms_at_0_rounds": ms[s][0],
                    "cycles_per_cta": cycles[rounds],
                    "cycles_per_cta_at_0_rounds": cycles[0]})


if __name__ == "__main__":
    main()
