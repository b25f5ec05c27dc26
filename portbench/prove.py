#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from, on the card.

    python3 portbench/prove.py --workload <cell> --seeds <n> ...
        [--control-seeds <n> ...] [--seconds 3] [--out <file>]

For each seed, in one process: the cell's configuration made resident
at its own size, a short window of the cell's own traffic, and the
check of `portbench.harness` (the numbers it compares and the
end-to-end metrics, one JSON line); on a control seed, then the same
window with the control switched on and its check. The benchmark's own
runs never switch the control on.

The control breaks the guarantee the configuration states, lossless
decode, the way a later change could be tempted to: the program
decodes with one resolve round fewer than its deepest chain needs
(`portbench.control.fewer_rounds`). Every check must read a number over
its limit under it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch
    from portbench import control, harness
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    out = open(args.out, "a") if args.out else None
    seeds = list(dict.fromkeys(args.seeds + args.control_seeds))
    try:
        for seed in seeds:
            t = time.perf_counter()
            worker = harness.HostSetup(ROOT, cell.config, seed)
            try:
                host = worker.result(timeout=harness.HOST_SETUP_TIMEOUT_S)
            finally:
                worker.stop()
            sess = harness.prepare(cell, seed, host)
            harness.warm(sess)
            setup = time.perf_counter() - t
            arms = (["program"] if seed in args.seeds else []) + (
                ["control"] if seed in args.control_seeds else [])
            for arm in arms:
                if arm == "control":
                    control.fewer_rounds(sess.store)
                    harness.warm(sess)
                line = reading(sess, cell, seed, arm, args.seconds, setup)
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(line) + "\n")
                    out.flush()
            harness.release(sess)
    finally:
        if out:
            out.close()
    return 0


def reading(sess, cell, seed: int, arm: str, seconds: float,
            setup_s: float) -> dict:
    from portbench import harness
    win = harness.run_window(sess, seconds)
    checks, wrong = harness.check(sess, win)
    ctx = harness.Context(cell=cell, setup_s=setup_s, window=win,
                          session=sess)
    metrics = harness.read_metrics(ROOT, cell.end_to_end, ctx)
    line = {"workload": cell.name, "seed": seed, "arm": arm,
            "attempted": len(win.requests), "checked": len(win.kept),
            "wrong_requests": wrong,
            "missing": win.missing,
            "correct": harness.correct(checks, len(win.kept), win.missing),
            "checks": checks, "metrics": metrics,
            "memory_peak_bytes": win.memory_peak_bytes}
    win.kept.clear()
    return line


if __name__ == "__main__":
    sys.exit(main())
