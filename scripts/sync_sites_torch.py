#!/usr/bin/env python3
"""Where the request path makes the host wait for the card.

    PYTHONPATH=src python scripts/sync_sites_torch.py [--blocks 64]

Runs one `fetch_block_range` request, one `fetch_reads` batch (the two
fused routes) and one verified `fetch_reads` batch through a block cache
(the staged route) on a small archive resident on the card, each under
`torch.cuda.set_sync_debug_mode("warn")`. For each it prints one JSON
line: the synchronizing calls found, by the innermost line of
`repro_torch` that made them, and what `repro_torch.obs.COUNTS
["host_syncs"]` counted over the same call. It exits 1 if the two
differ on a fused route. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.core.encoder import encode  # noqa: E402
from repro_torch.core.index import ReadIndex  # noqa: E402
from repro_torch.core.residency import CompressedResidentStore  # noqa: E402
from repro_torch.data.fastq import make_fastq  # noqa: E402


def sync_sites(fn) -> collections.Counter:
    """{"file:line function": synchronizing calls} of one call of `fn`."""
    found = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        # the sync debug mode's own notice, once, is not a sync
        if "called a synchronizing CUDA operation" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if "warnings" not in f.filename]
        mine = [f for f in stack if "repro_torch" in f.filename
                and "obs.py" not in f.filename]
        f = (mine or stack)[-1]
        name = Path(f.filename).as_posix().split("/src/")[-1]
        found[f"{name}:{f.lineno} {f.name}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return found


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--blocks", type=int, default=64)
    p.add_argument("--block-size", type=int, default=16384)
    args = p.parse_args(argv)
    bs = args.block_size
    data = make_fastq("noisy", n_reads=args.blocks * bs // 240, seed=7)
    a = encode(data, block_size=bs)
    index = ReadIndex.build(data, bs)
    fused = CompressedResidentStore(a, index, device="cuda")
    staged = CompressedResidentStore(a, index, device="cuda",
                                     cache_blocks=8, verify=True)
    ids = np.random.default_rng(7).integers(0, index.n_reads, 512)
    cases = {
        "fetch_block_range": (True, lambda: fused.fetch_block_range(
            1, a.n_blocks - 1)),
        "fetch_reads": (True, lambda: fused.fetch_reads(ids)),
        "fetch_reads_staged": (False, lambda: staged.fetch_reads(ids)),
    }
    bad = 0
    for name, (exact, fn) in cases.items():
        fn()                                  # build and warm the kernels
        torch.cuda.synchronize()
        before = obs.COUNTS["host_syncs"]
        sites = sync_sites(fn)
        counted = obs.COUNTS["host_syncs"] - before
        found = sum(sites.values())
        bad += exact and counted != found
        print(json.dumps({"case": name, "syncs_found": found,
                          "host_syncs_counted": counted,
                          "sites": dict(sites)}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
