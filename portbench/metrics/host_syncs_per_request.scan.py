"""host_syncs_per_request.scan: calls at which the host waits for the card
per entry call, the program's counters `host_syncs / requests`
(`repro_torch.obs.COUNTS`) over the process's life, warm-up included
(every scan request is alike)."""


def read(ctx):
    if ctx.kind != "scan":
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    requests = obs.COUNTS.get("requests", 0)
    if requests <= 0:
        return None
    return obs.COUNTS["host_syncs"] / requests
