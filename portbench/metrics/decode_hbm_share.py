"""decode_hbm_share: compressed bytes of the blocks decoded plus raw
bytes delivered, by the scan requests issued in the traced window, at
3.35e12 B/s, over the card's busy time (union of the intervals of every
operation on it) in that window, in %. It counts the work and not the
kernels, so it bounds a gain whatever kernels do the work."""
from portbench import roofline


def read(ctx):
    if ctx.kind != "scan" or ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    reqs = [r for r in ctx.traced() if r.spec is not None]
    if not reqs:
        return None
    n_bytes = 0.0
    for r in reqs:
        w = ctx.work.of_range(*r.spec)
        n_bytes += w["compressed"] + w["raw"]
    return 100.0 * n_bytes / roofline.PEAK_BYTES / ctx.trace.busy_s
