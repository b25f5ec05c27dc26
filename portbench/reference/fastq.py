"""The benchmark's own FASTQ generator, frozen.

It makes the records a configuration file describes, from the seed, and
is kept here, not imported from the program, so that a change to the
program cannot change what the benchmark measures, and so that the
reference and the program read the same bytes made by neither.

A configuration gives:

  run        the run accession the headers carry: "@<run>.<i> <i>/1"
  read_len   bases a read
  qualities  the quality alphabet (Phred+33 characters), drawn uniformly

Each read's bases are drawn uniformly over ACGT, independently of every
other read: a whole-genome run read in file order sends each read from
its own place in the genome, so no two reads of one block share a
fragment. Qualities are drawn independently per base.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
HEAD_AND_SEPARATORS = 16      # bytes of a record besides its bases and
                              # qualities are at least this many


def make_fastq(params: dict, n_reads: int, rng: np.random.Generator
               ) -> Tuple[bytes, np.ndarray]:
    """`n_reads` FASTQ records → (bytes, i64[n_reads + 1] record starts
    with the end as sentinel)."""
    L = int(params["read_len"])
    seq = BASES[rng.integers(0, 4, (n_reads, L))]
    alpha = np.frombuffer(params["qualities"].encode(), np.uint8)
    qual = alpha[rng.integers(0, alpha.size, (n_reads, L))]
    seq_b, qual_b = seq.tobytes(), qual.tobytes()
    run = params["run"].encode()
    recs = [b"@%s.%d %d/1\n" % (run, i + 1, i + 1)
            + seq_b[i * L:(i + 1) * L] + b"\n+\n"
            + qual_b[i * L:(i + 1) * L] + b"\n"
            for i in range(n_reads)]
    lens = np.fromiter((len(r) for r in recs), np.int64, n_reads)
    starts = np.concatenate([[0], np.cumsum(lens)])
    return b"".join(recs), starts


def aligned_tile(params: dict, n_blocks: int, block_size: int,
                 rng: np.random.Generator) -> Tuple[bytes, np.ndarray]:
    """A FASTQ tile of exactly `n_blocks * block_size` bytes that ends on a
    record boundary → (bytes, i64 record starts with sentinel). Whole
    records; the last one's header is padded with " xxx..." to the block
    edge, so the tile repeats end to end as whole records."""
    target = n_blocks * block_size
    n_reads = target // (2 * int(params["read_len"])
                         + HEAD_AND_SEPARATORS) + 64
    data, starts = make_fastq(params, n_reads, rng)
    k = int(np.searchsorted(starts, target, side="right")) - 1
    if k < 1:
        raise ValueError(f"tile of {target} bytes holds no whole record")
    cut = int(starts[k])
    fill = target - cut
    starts = np.concatenate([starts[:k], [target]])
    if not fill:
        return data[:cut], starts
    head_end = data.index(b"\n", int(starts[k - 1]))
    return (data[:head_end] + b" " + b"x" * (fill - 1) + data[head_end:cut],
            starts)
