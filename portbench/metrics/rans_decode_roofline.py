"""rans_decode_roofline: the least time the H100 could take for what the
`rans_decode_kernel` launches of the traced window decode (bytes at 3.35e12
B/s or integer operations at 33.5e12/s, whichever is longer; the counts
of `portbench.roofline`), over their device time, in %."""
from portbench import roofline


def read(ctx):
    if ctx.kind != "scan" or ctx.trace is None:
        return None
    n, device_s = ctx.trace.kernel("rans_decode_kernel")
    reqs = [r for r in ctx.traced() if r.spec is not None]
    if not n or device_s <= 0 or not reqs:
        return None
    work = [ctx.work.of_range(*r.spec) for r in reqs]
    per_launch = roofline.bound_s(
        sum(w["rans_bytes"] for w in work) / len(work),
        sum(w["rans_ops"] for w in work) / len(work))
    return 100.0 * per_launch * n / device_s
