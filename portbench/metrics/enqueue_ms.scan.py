"""enqueue_ms.scan: host time a scan request spends putting work on the
card, the union of the program's `repro_torch.upload` (the pageable
copies of the plan's coordinates, each of which waits for the stream),
`entropy`, `match` and `gather` spans, in ms, over the
`repro_torch.fetch_block_range` spans of the traced window (host clock;
`portbench.program_spans`)."""
from portbench import program_spans


def read(ctx):
    if ctx.kind != "scan":
        return None
    return program_spans.per_request_ms(
        ctx, ["upload", "entropy", "match", "gather"])
