"""gather_device_ms.scan: device time of the ragged gather a scan request
runs, in ms: the operations on the stream after each request's
`lz77_match_kernel` up to the next host-to-device copy (device trace),
over the `repro_torch.fetch_block_range` spans of the traced window
(`portbench.program_spans`)."""
from portbench import program_spans


def read(ctx):
    if ctx.kind != "scan" or ctx.trace is None:
        return None
    n = sum(1 for s in program_spans.host_spans(ctx)
            if s[0] == program_spans.ENTRY)
    device_s = program_spans.gather_device_s(ctx.trace)
    if not n or device_s <= 0:
        return None
    return device_s / n * 1e3
