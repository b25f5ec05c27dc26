"""Resident-scale archives without a resident-scale encode.

Host encode runs at about a megabyte a second, so an 8 GiB corpus is not
encoded byte by byte. Instead a block-aligned, record-aligned FASTQ
corpus is encoded once and its archive is tiled. This is exact:

  * "ra" blocks are self-contained, so each tile's blocks encode to the
    same commands, streams, depths and digests as the original's;
  * the entropy tables come from the archive-wide histogram, which the
    tiling multiplies by `tiles`; with `tiles` a power of two,
    `entropy.normalize_freqs` sees the same float64 ratios bit for bit
    (hist·2^k · scale/(total·2^k) == hist · scale/total), so the tables,
    hence every rANS stream, are unchanged.

So `tile_archive(encode(corpus), T)` equals `encode(corpus * T)` field
for field, parity tail included when the parity groups divide the
blocks (a CPU test holds the two against each other at a small size).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.format import Archive, file_digest
from repro_torch.core.index import ReadIndex, parse_fastq_records
from repro_torch.data.fastq import make_fastq


def aligned_fastq(n_blocks: int, block_size: int, kind: str = "platinum",
                  seed: int = 0) -> bytes:
    """A FASTQ corpus of exactly `n_blocks * block_size` bytes that ends on
    a record boundary: whole `make_fastq` records, the last record's
    header line padded with filler characters to the block edge."""
    target = n_blocks * block_size
    data = make_fastq(kind, n_reads=target // 200 + 64, seed=seed)
    if len(data) < target:
        raise ValueError(f"corpus of {len(data)} bytes is short of {target}")
    starts = parse_fastq_records(data)[0].astype(np.int64)
    k = int(np.searchsorted(starts, target, side="right")) - 1
    cut, last = int(starts[k]), int(starts[k - 1])
    head_end = data.index(b"\n", last)
    fill = target - cut
    if not fill:
        return data[:cut]
    return (data[:head_end] + b" " + b"x" * (fill - 1)
            + data[head_end:cut])


def tile_archive(a: Archive, tiles: int) -> Archive:
    """The archive of `tiles` back-to-back copies of `a`'s data.

    A parity archive tiles when its `parity_group` divides `n_blocks`:
    every parity group then lies inside one tile, so each tile's groups
    XOR the same payloads into the same rows, and only the row offsets
    shift by the parity words of the tiles before."""
    if a.mode != "ra":
        raise ValueError("only 'ra' archives tile")
    if a.parity_group and a.n_blocks % a.parity_group:
        raise ValueError(
            f"parity_group={a.parity_group} must divide the tiled "
            f"archive's {a.n_blocks} blocks, so no group straddles tiles")
    if tiles < 1 or tiles & (tiles - 1):
        raise ValueError(f"tiles={tiles} must be a power of two")
    if a.raw_size % a.block_size:
        raise ValueError("the tiled corpus must be block-aligned")
    W = a.words.size
    nb = a.n_blocks
    t = np.arange(tiles, dtype=np.int64)
    block_fnv = np.tile(a.block_fnv, tiles)
    return dataclasses.replace(
        a,
        raw_size=a.raw_size * tiles,
        words=np.tile(a.words, tiles),
        word_off=(a.word_off[None] + (t * W)[:, None, None]).reshape(-1, 4),
        n_words=np.tile(a.n_words, (tiles, 1)),
        n_syms=np.tile(a.n_syms, (tiles, 1)),
        lanes=np.tile(a.lanes, (tiles, 1)),
        n_cmds=np.tile(a.n_cmds, tiles),
        block_start=np.arange(nb * tiles, dtype=np.int64) * a.block_size,
        block_len=np.tile(a.block_len, tiles),
        block_fnv=block_fnv,
        file_fnv=file_digest(block_fnv),
        block_depth=(np.tile(a.block_depth, tiles)
                     if a.block_depth is not None else None),
        parity_words=np.tile(a.parity_words, tiles),
        parity_off=np.append(
            (a.parity_off[None, :-1]
             + (t * a.parity_words.size)[:, None]).reshape(-1),
            np.int64(a.parity_words.size * tiles)),
    )


def tile_index(index: ReadIndex, tiles: int, raw_size: int) -> ReadIndex:
    """The ReadIndex of `tiles` back-to-back copies of a `raw_size`-byte
    corpus that ends on a record boundary."""
    starts = np.asarray(index.starts, np.uint64)
    body = (starts[None, :-1]
            + (np.arange(tiles, dtype=np.uint64) * np.uint64(raw_size))
            [:, None]).reshape(-1)
    return ReadIndex(
        starts=np.concatenate([body, [np.uint64(raw_size * tiles)]]),
        block_size=index.block_size)
