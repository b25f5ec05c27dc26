"""The roofline of one measured step on one card: its model FLOPs beside
its counted FLOPs and bytes, its MFU, and its roofline time on the H100
constants and that time's share of the measured step.

    counted = count_step(step, state, batch, device="cuda")
    step_roofline(model_flops_train(cfg, B * T), counted, step_s)

`count_step` runs the step once under the dry-run's counting mode
(`launch/dryrun.py::CostMode`) on plain tensors of one device: FLOPs by
`torch.utils.flop_counter`'s formulas, bytes as each op's inputs plus
outputs (eager, unfused), and the peak of live bytes its ops allocated.
On meta tensors (`device="meta"`) it counts the same step without running
it: the two agree on FLOPs, which depend on shapes only.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.decoder import resolve_device
from repro_torch.roofline import hlo_costs as rl


def count_step(fn, *args, device="cuda") -> Dict:
    """{"flops", "bytes", "temp"} of one call `fn(*args)`, whose tensors
    must all lie on `device` (default the card; raises without one)."""
    from repro_torch.launch.dryrun import CostMode
    dev = resolve_device(device)
    for t in pytree.tree_leaves(args):
        if isinstance(t, torch.Tensor) and t.device.type != dev.type:
            raise ValueError(f"count_step on {dev}: a tensor lies on "
                             f"{t.device}")
    with CostMode() as c:
        fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"flops": c.flops, "bytes": c.bytes, "temp": c.peak_live}


def meta_like(tree):
    """`tree` with every tensor replaced by a meta tensor of its shape
    and dtype."""
    return pytree.tree_map_only(
        torch.Tensor, lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"), tree)


def step_roofline(model_flops: float, counted: Dict, step_s: float) -> Dict:
    """The measured step's MFU and roofline on one H100: compute and
    memory times of its counted FLOPs and bytes, the larger of them (the
    roofline step time), its share of the measured `step_s`, and which
    of the two bounds it."""
    compute_s = counted["flops"] / rl.PEAK_FLOPS
    memory_s = counted["bytes"] / rl.HBM_BW
    roof_s = max(compute_s, memory_s)
    return {"model_flops": model_flops, "counted_flops": counted["flops"],
            "counted_bytes": counted["bytes"], "step_ms": step_s * 1e3,
            "mfu": rl.mfu(model_flops, step_s),
            "compute_ms": compute_s * 1e3, "memory_ms": memory_s * 1e3,
            "roofline_ms": roof_s * 1e3,
            "roofline_share": roof_s / step_s,
            "bound_by": "compute" if compute_s >= memory_s else "memory",
            "peak_flops": rl.PEAK_FLOPS, "hbm_bw": rl.HBM_BW}
