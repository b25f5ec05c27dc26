"""Read-level random-access indices (paper §4.1).

ReadIndex   — 8 bytes/read: the absolute output byte where the read starts
              (block id + in-block offset fall out arithmetically, and the
              read's extent is delimited by the next entry). This is the
              compact read→block index the paper sizes against `.fai`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


def parse_fastq_records(data: bytes) -> Tuple[np.ndarray, List[bytes]]:
    """Record start offsets (u64[n_reads+1], sentinel end) + read names.

    EOF counts as the final line terminator, so FASTQ without a trailing
    newline parses identically. Empty input is zero records (sentinel-only
    starts), not an error. Malformed records — header not starting with
    '@', separator line not starting with '+', or sequence/quality length
    mismatch — raise ValueError naming the first bad record instead of
    silently mis-indexing downstream (`FaiIndex.build` would otherwise
    `bytes.index` its way into the wrong fields).
    """
    if not data:
        return np.zeros(1, np.uint64), []
    arr = np.frombuffer(data, np.uint8)
    nl = np.flatnonzero(arr == ord(b"\n"))
    ends = nl if data.endswith(b"\n") else np.concatenate([nl, [len(data)]])
    if ends.size % 4:
        raise ValueError(
            f"truncated FASTQ: {ends.size} lines is not a multiple of 4 "
            "(each record is @name / sequence / + / quality)")
    line_starts = np.concatenate([[0], ends[:-1] + 1])
    rec_starts = line_starts[0::4]
    bad = np.flatnonzero(arr[rec_starts] != ord(b"@"))
    if bad.size:
        r = int(bad[0])
        raise ValueError(
            f"malformed FASTQ record {r}: header line does not start with "
            f"'@' (got {data[rec_starts[r]:rec_starts[r] + 20]!r})")
    sep_starts = line_starts[2::4]
    bad = np.flatnonzero((arr[np.minimum(sep_starts, len(data) - 1)]
                          != ord(b"+")) | (sep_starts >= ends[2::4]))
    if bad.size:
        r = int(bad[0])
        raise ValueError(
            f"malformed FASTQ record {r}: third line must start with the "
            f"'+' separator (got {data[sep_starts[r]:ends[4 * r + 2]]!r})")
    seq_len = ends[1::4] - line_starts[1::4]
    qual_len = ends[3::4] - line_starts[3::4]
    bad = np.flatnonzero(seq_len != qual_len)
    if bad.size:
        r = int(bad[0])
        raise ValueError(
            f"malformed FASTQ record {r}: sequence is {int(seq_len[r])} "
            f"bytes but quality is {int(qual_len[r])}")
    names = []
    for i, s in enumerate(rec_starts):
        e = int(ends[4 * i])
        names.append(data[s + 1:e].split(b" ")[0])
    starts = np.concatenate([rec_starts, [len(data)]]).astype(np.uint64)
    return starts, names


def split_starts(starts: np.ndarray,
                 block_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """u64 absolute offsets → (block i32, in-block offset i32).

    The device-resident form of the start table: a flat int32 table
    truncates offsets in archives ≥ 2 GiB. Block ids and in-block offsets
    each fit i32 individually (offset = block * block_size + rem in 64-bit), so the
    split table is lossless for any archive whose block COUNT fits i32 —
    petabytes at practical block sizes.
    """
    s = np.asarray(starts).astype(np.uint64)
    blk = s // np.uint64(block_size)
    if blk.size and int(blk.max()) >= 2**31:
        raise OverflowError(
            f"block id {int(blk.max())} exceeds int32; raise block_size")
    rem = (s - blk * np.uint64(block_size)).astype(np.int32)
    return blk.astype(np.int32), rem


@dataclasses.dataclass
class ReadIndex:
    """8 B/read: absolute start offset. Block = start // block_size."""
    starts: np.ndarray            # u64[n_reads + 1]
    block_size: int

    @property
    def n_reads(self) -> int:
        return int(self.starts.shape[0] - 1)

    @property
    def nbytes(self) -> int:
        return self.n_reads * 8    # on-disk cost (sentinel amortized away)

    def lookup(self, r: int) -> Tuple[int, int, int]:
        """→ (start_byte, end_byte, first_block). O(1) array loads."""
        s = int(self.starts[r])
        e = int(self.starts[r + 1])
        return s, e, s // self.block_size

    def covering_blocks(self, r: int) -> Tuple[int, int]:
        s, e, b0 = self.lookup(r)
        return b0, -(-e // self.block_size)

    def serialize(self) -> bytes:
        return self.starts[:-1].astype("<u8").tobytes()

    @classmethod
    def build(cls, data: bytes, block_size: int) -> "ReadIndex":
        starts, _ = parse_fastq_records(data)
        return cls(starts=starts, block_size=block_size)

    @classmethod
    def fixed_records(cls, n_records: int, record_bytes: int,
                      block_size: int) -> "ReadIndex":
        """Index for fixed-size records (the tokenized-corpus case)."""
        starts = (np.arange(n_records + 1, dtype=np.uint64)
                  * np.uint64(record_bytes))
        return cls(starts=starts, block_size=block_size)
