#!/usr/bin/env python3
"""What the request path's spans cost while no profiler records.

    PYTHONPATH=src python scripts/span_cost_torch.py [--calls 1000000]

Times `--calls` no-op `repro_torch.obs.span` blocks, and as many calls of
a function under `obs.spanned` against the same function bare, on the
host's clock, best of five, and prints the cost of one span in ns.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import obs  # noqa: E402


def _best(fn, calls: int) -> float:
    """Least seconds over five runs of `fn(calls)`."""
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        fn(calls)
        best = min(best, time.perf_counter() - t)
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--calls", type=int, default=10**6)
    args = p.parse_args(argv)
    n = args.calls

    def bare():
        return None

    spanned = obs.spanned("plan")(bare)

    def with_blocks(k):
        for _ in range(k):
            with obs.span("plan"):
                pass

    def empty_loop(k):
        for _ in range(k):
            pass

    def bare_calls(k):
        for _ in range(k):
            bare()

    def spanned_calls(k):
        for _ in range(k):
            spanned()

    loop = _best(empty_loop, n)
    out = {"calls": n,
           "with_span_ns": (_best(with_blocks, n) - loop) / n * 1e9,
           "spanned_call_extra_ns": (_best(spanned_calls, n)
                                     - _best(bare_calls, n)) / n * 1e9}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
