"""scan: consecutive block ranges of `request_blocks` blocks through
`fetch_block_range`, the output left on the device.

The scan starts at a block drawn from the seed and moves on by a
request's length n; of an archive of N blocks, the range after [b, b +
n) starts at (b + n) mod (N - n + 1), so every range has the same length
and lies inside the archive, and, where n does not divide N, the ranges
fall at other offsets on each pass."""
from __future__ import annotations

import numpy as np


def check(traffic: dict) -> None:
    if int(traffic.get("request_blocks", 0)) < 1:
        raise ValueError("scan traffic needs request_blocks >= 1")


def requests(traffic, ref, rng):
    nb = int(traffic["request_blocks"])
    if nb > ref.n_blocks:
        raise ValueError(f"request_blocks={nb} exceeds the archive's "
                         f"{ref.n_blocks} blocks")
    starts = ref.n_blocks - nb + 1          # where a range may start
    b = int(rng.integers(0, starts))
    while True:
        yield b, b + nb
        b = (b + nb) % starts


def entry(store):
    def call(spec):
        return store.fetch_block_range(spec[0], spec[1])
    return call


def size(spec, ref):
    n = spec[1] - spec[0]
    return n, n * ref.block_size


def record(spec):
    return spec


def wrong_bytes(ref, spec, out) -> int:
    want = ref.block_rows(*spec)
    if out.shape != want.shape:
        return want.size
    return int(np.count_nonzero(out != want))
