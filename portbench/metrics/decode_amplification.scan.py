"""decode_amplification.scan: rows the decode materialized over the
unique covering blocks the requests asked for, the program's counters
`blocks.decoded / blocks.covered` (`repro_torch.obs.COUNTS`) over the
process's life, warm-up included (every scan request is alike)."""


def read(ctx):
    if ctx.kind != "scan":
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    covered = obs.COUNTS.get("blocks.covered", 0)
    if covered <= 0:
        return None
    return obs.COUNTS["blocks.decoded"] / covered
