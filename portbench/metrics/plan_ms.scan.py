"""plan_ms.scan: host time a scan request spends in the planner, the
program's `repro_torch.plan` spans (`QueryPlanner.plan_spans` and the
plan's host coordinates, `DecodePlan.host_spans` and `host_cover`), in
ms, over the `repro_torch.fetch_block_range` spans of the traced window
(host clock; `portbench.program_spans`)."""
from portbench import program_spans


def read(ctx):
    if ctx.kind != "scan":
        return None
    return program_spans.per_request_ms(ctx, ["plan"])
