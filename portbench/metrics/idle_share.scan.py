"""idle_share.scan: share of the traced window in which no operation ran
on the card, 100 x (1 - busy union / window), from the device trace."""


def read(ctx):
    if (ctx.kind != "scan" or ctx.trace is None or ctx.trace.busy_s <= 0
            or ctx.trace.window_s <= 0):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
