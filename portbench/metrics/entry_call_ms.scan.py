"""entry_call_ms.scan: host time inside each `fetch_block_range` call (planner,
executor, the covering-set sync and the enqueue of the decode), mean
over the requests of the window's untraced part, host clock."""


def read(ctx):
    if ctx.kind != "scan":
        return None
    reqs = ctx.untraced()
    if not reqs:
        return None
    return sum(r.t_return - r.t_issue for r in reqs) / len(reqs) * 1e3
