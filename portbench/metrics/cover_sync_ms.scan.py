"""cover_sync_ms.scan: host time a scan request is blocked in the covering
set's `torch.unique`, which reads the set's size back, the program's
`repro_torch.cover_sync` spans, in ms, over the
`repro_torch.fetch_block_range` spans of the traced window (host clock;
`portbench.program_spans`)."""
from portbench import program_spans


def read(ctx):
    if ctx.kind != "scan":
        return None
    return program_spans.per_request_ms(ctx, ["cover_sync"])
