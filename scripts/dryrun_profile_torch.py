#!/usr/bin/env python3
"""Where one trace of a dry-run cell of the PyTorch port spends its host
time, by sampling its stack.

    PYTHONPATH=src python scripts/dryrun_profile_torch.py --arch xlstm-350m \
        --shape train_4k --mesh multi --depth 1 --seq 256 [--seconds 300]

Runs one reduced-depth trace of the cell as `launch/dryrun.py` fits it
(`_measure_cell` at `--depth` units, the sequence cut to `--seq`) and,
every SAMPLE_S seconds, reads the stack of the thread running it. Each
sample is classed by the first DTensor function of STAGES on the stack
(innermost first), by the op whose sharding DTensor was propagating, if
any, and by whether it lay in one of `CostMode`'s fallbacks (a function
of FALLBACK_FRAMES on the stack). Prints one JSON object: wall seconds,
whether the trace finished (`--seconds` ends the process and keeps what
was sampled), its fallback counts (when it finished) and the samples so
classed. The samples are read from the outside: nothing of the dry-run
or of DTensor is patched. (cProfile reads no cumulative time for frames
that torch's dispatcher enters from C++, such as `__torch_dispatch__`.)
"""
import argparse
import collections
import dataclasses as dc
import json
import os
import sys
import threading
import time

import torch

from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_production_mesh

SAMPLE_S = 0.1
STAGES = {  # DTensor functions a sample is classed by, innermost first
    "_compute_placement_transition_cost": "redistribute cost search",
    "find_min_cost_path": "redistribute cost search",
    "expand_to_full_mesh_op_strategy": "strategy expansion",
    "redistribute_local_tensor": "redistribute",
    "_propagate_tensor_meta_non_cached": "fake-tensor propagation",
    "propagate_op_sharding_non_cached": "sharding propagation (other)",
}
# CostMode's fallbacks: the redistributes of "partial" (`rep`, and
# `_scatter_partials` on a 3-D mesh) and "replicate" (`rep`), "flatten",
# "local", "whole" (`full_tensor`) and "masked"
FALLBACK_FRAMES = ("rep", "_scatter_partials", "_flatten_local",
                   "_unflatten_local", "_pointwise_local", "_local_operands",
                   "full_tensor", "_reduce_masked")


def classify(frame) -> tuple:
    """(stage, op or None, in a fallback) of one sample's stack."""
    names, op, fell = [], None, False
    while frame is not None:
        name = frame.f_code.co_name
        names.append(name)
        if name == "propagate_op_sharding_non_cached":
            schema = frame.f_locals.get("op_schema")
            op = str(getattr(schema, "op", op))   # the outermost one
        fell = fell or name in FALLBACK_FRAMES
        frame = frame.f_back
    stage = next((STAGES[n] for n in names if n in STAGES),
                 "local ops, model")
    return stage, op, fell


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args()
    torch.set_num_threads(1)

    cfg = get_config(args.arch)
    shape = SHAPES_BY_NAME[args.shape]
    if args.seq:
        shape = dc.replace(shape, seq_len=args.seq)
    mesh = make_production_mesh(multi_pod=args.mesh == "multi")
    main_id = threading.get_ident()
    stages, ops = collections.Counter(), collections.Counter()
    lock = threading.Lock()

    def report(done, wall, fallbacks):
        print(json.dumps({
            "cell": f"{args.arch} {args.shape} {args.mesh} "
                    f"depth={args.depth} seq={shape.seq_len}",
            "torch": torch.__version__, "done": done,
            "wall_s": round(wall, 1), "sample_s": SAMPLE_S,
            "samples": sum(stages.values()), "fallbacks": fallbacks,
            "by_stage": dict(stages.most_common()),
            "by_propagated_op": dict(ops.most_common(8))}), flush=True)

    def sampler():
        # a trace past --seconds ends from this thread: an interrupt of
        # the main thread (SIGINT) did not end a multi-pod trace
        while True:
            time.sleep(SAMPLE_S)
            with lock:
                wall = time.perf_counter() - t0
                if args.seconds and wall > args.seconds:
                    report(False, wall, {})
                    os._exit(0)
                stage, op, fell = classify(
                    sys._current_frames().get(main_id))
                stages[("fallback: " if fell else "") + stage] += 1
                if op is not None:
                    ops[op] += 1

    t0 = time.perf_counter()
    threading.Thread(target=sampler, daemon=True).start()
    m = dr._measure_cell(cfg, args.depth, shape, mesh, "full",
                         dr.rules_for(cfg), dr._depth_cfg)
    with lock:
        report(True, time.perf_counter() - t0,
               {k[3:]: int(v) for k, v in m.items()
                if k.startswith("fb_") and not k.endswith("_bytes") and v})
        os._exit(0)


if __name__ == "__main__":
    main()
