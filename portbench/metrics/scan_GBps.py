"""scan_GBps: raw bytes the scan delivered on the card over the whole
window, in GB/s (10^9 bytes), host clock."""


def read(ctx):
    if ctx.kind != "scan" or ctx.window_s <= 0:
        return None
    return sum(r.raw_bytes for r in ctx.requests) / ctx.window_s / 1e9
