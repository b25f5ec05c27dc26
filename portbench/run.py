#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout. The last line of standard output is one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with `--trace 0`, its per-layer metrics with
`--trace 1`), `device`, with `--trace 1` `breakdown`, and last `checks`,
each number compared with its limit. The same numbers end standard
error. Without a CUDA card, or with fewer cards than the cell asks
for, it exits non-zero and prints no result; so it does if `jax`,
`jaxlib`, `flax` or `repro` is loaded when the window has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout (the
# kernels themselves build into build/kernels/, see
# repro_torch/kernels/_build.py)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import harness
    t_start = time.perf_counter() - harness.process_age_s()
    cell = harness.load_cell(ROOT, args.workload)
    # the host half of set-up (tile, encode, index) runs in a worker
    # while this process loads torch and starts the card
    worker = harness.HostSetup(ROOT, cell.config, args.seed)
    try:
        import torch
        if not torch.cuda.is_available():
            print("no CUDA card: the benchmark measures the card only",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        torch.cuda.set_device(0)
        torch.zeros(1, device="cuda").sum().item()
        t_card = time.perf_counter()
        host = worker.result(timeout=harness.HOST_SETUP_TIMEOUT_S)
        t_host = time.perf_counter()
    finally:
        worker.stop()
    result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), host, device="cuda",
                         t_start=t_start, cell=cell)
    result["setup_parts_s"].update(card_start=t_card - t_start,
                                   worker_wait=t_host - t_card)
    found = harness.banned_modules()
    if found:
        print(f"modules loaded that the run may not load: {found}",
              file=sys.stderr)
        return 3
    print(f"checked requests: {result['checked_requests']} of "
          f"{result['attempted']}, never completed: "
          f"{result['missing_requests']}; correct: {result['correct']}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
