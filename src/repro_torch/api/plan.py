"""Query planning: any batch of addresses → one `DecodePlan`.

This module is THE place the covering-block math lives. The device-side
twin of the same arithmetic lives in `residency._fetch_dev_core` (the
fast path computes the covering set from the device start table), and
`covering_blocks` below is its host mirror — change one, change both.

A `DecodePlan` is the lowered form of a query batch: absolute byte spans,
padded batch/output geometry, and — lazily, for the staged path — the
unique covering-block selection plus the ragged row map the gather
consumes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.address import Address, ByteRange, Region, normalize


def span_coords(starts: np.ndarray, lengths: np.ndarray, block_size: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Absolute byte spans → (b0, r0, end_blk): first covering block,
    in-block offset, exclusive covering end. The one host implementation
    of the paper's §4 position-invariant coordinate map."""
    starts = np.asarray(starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    b0 = starts // block_size
    r0 = (starts - b0 * block_size).astype(np.int32)
    end_blk = -(-(starts + lengths) // block_size)
    return b0, r0, end_blk


def covering_blocks(starts: np.ndarray, lengths: np.ndarray, block_size: int,
                    n_blocks: int, max_span: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
    """`span_coords` plus the (B, max_span) cover matrix: slots past a
    span's last block collapse onto its first block (they dedup away
    instead of decoding strangers)."""
    b0, r0, end_blk = span_coords(starts, lengths, block_size)
    cover = b0[:, None] + np.arange(max_span, dtype=np.int64)[None, :]
    cover = np.where(cover < end_blk[:, None], cover, b0[:, None])
    cover = np.clip(cover, 0, n_blocks - 1)
    return b0, r0, end_blk, cover


def pad_pow2_spans(starts: np.ndarray, lengths: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a span batch to the next power of two by repeating the last span
    (dup slots add no unique blocks)."""
    n = starts.size
    cap = 1 << max(0, n - 1).bit_length() if n > 1 else 1
    if cap == n or n == 0:
        return starts, lengths
    reps = np.full(cap - n, -1)
    return (np.concatenate([starts, starts[reps]]),
            np.concatenate([lengths, lengths[reps]]))


@dataclasses.dataclass
class DecodePlan:
    """A lowered query batch. `starts`/`lengths` are pow2-padded absolute
    byte spans; the first `n_queries` rows are the real queries."""
    starts: np.ndarray            # i64[Bp]
    lengths: np.ndarray           # i64[Bp]
    n_queries: int                # pre-padding batch size
    block_size: int
    n_blocks: int
    max_len: int                  # padded output width
    max_span: int                 # covering-span bound
    device_ids: Optional[np.ndarray] = None   # i32[Bp]: whole-record ids —
                                  # covering set resolves from the DEVICE
                                  # start table (the fetch_reads fast path)
    max_depth: Optional[int] = None  # archive's recorded resolve-round
                                  # bound (None = legacy early-exit decode)
    block_rounds: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)  # i32[n_blocks] per-block scheduled
                                  # resolve rounds (pow2 depth buckets,
                                  # `core.depth.scheduled_rounds`)
    _cover: Optional[tuple] = dataclasses.field(default=None, repr=False)

    # ------------------------------------------------------------- geometry
    @property
    def batch(self) -> int:
        return int(self.starts.size)

    def geom(self) -> tuple:
        """(block_size, n_blocks, max_len, max_span)."""
        return (self.block_size, self.n_blocks, self.max_len, self.max_span)

    # ----------------------------------------------------------- host cover
    def host_spans(self) -> tuple:
        """(b0, r0, end_blk) — the per-span covering coordinates the device
        path consumes (it deduplicates the covering set on device)."""
        return span_coords(self.starts, self.lengths, self.block_size)

    def host_cover(self) -> tuple:
        """(b0, r0, end_blk, unique_blocks, row_map) — computed lazily; only
        the staged path needs it."""
        if self._cover is None:
            b0, r0, end_blk, cover = covering_blocks(
                self.starts, self.lengths, self.block_size, self.n_blocks,
                self.max_span)
            uniq = np.unique(cover)
            row_map = np.searchsorted(uniq, cover).astype(np.int32)
            self._cover = (b0, r0, end_blk, uniq, row_map)
        return self._cover

    # ---------------------------------------------------------- depth groups
    def depth_groups(self) -> Optional[list]:
        """The plan's unique covering set partitioned by scheduled resolve
        rounds: [(n_rounds, idx-into-uniq)], ascending. None = legacy
        archive without depth metadata."""
        if self.block_rounds is None:
            return None
        _, _, _, uniq, _ = self.host_cover()
        r = self.block_rounds[uniq]
        return [(int(v), np.flatnonzero(r == v)) for v in np.unique(r)]

    def needed_rounds(self) -> Optional[int]:
        """Max scheduled rounds over the covering set — strictly below
        `max_depth` exactly when the whole selection avoids the archive's
        deepest bucket."""
        if self.block_rounds is None:
            return None
        _, _, _, uniq, _ = self.host_cover()
        return int(self.block_rounds[uniq].max(initial=0))


class QueryPlanner:
    """Lowers a batch of read-id and byte-range addresses to one DecodePlan.

    Works over a `CompressedResidentStore` (or the bare-decoder adapter in
    `repro_torch.api.executors`). Region addresses need the name table,
    which comes with a later slice of the port.
    """

    def __init__(self, store):
        self.store = store
        da = store.decoder.da
        self.block_size = da.block_size
        self.n_blocks = da.n_blocks
        self.raw_size = da.raw_size

    @property
    def max_depth(self) -> Optional[int]:
        return self.store.decoder.da.max_depth

    @property
    def block_rounds(self) -> Optional[np.ndarray]:
        return self.store.decoder.block_rounds

    # ------------------------------------------------------------ fast paths
    def plan_read_ids(self, ids: np.ndarray) -> DecodePlan:
        """All-ReadId batches: geometry is store-static and the covering set
        resolves from the device start table."""
        idx = self.store.index
        if idx is None:
            raise ValueError("read-id addresses require a ReadIndex")
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= idx.n_reads):
            raise IndexError(
                f"read id out of range [0, {idx.n_reads}): "
                f"{int(ids.min())}..{int(ids.max())}")
        starts64 = self.store._starts64
        starts, lengths = pad_pow2_spans(
            starts64[ids], starts64[ids + 1] - starts64[ids])
        dev_ids = np.empty(starts.size, np.int64)
        dev_ids[:ids.size] = ids
        dev_ids[ids.size:] = ids[-1] if ids.size else 0
        return DecodePlan(
            starts=starts, lengths=lengths, n_queries=ids.size,
            block_size=self.block_size, n_blocks=self.n_blocks,
            max_len=self.store._max_len, max_span=self.store._max_span,
            device_ids=dev_ids.astype(np.int32), max_depth=self.max_depth,
            block_rounds=self.block_rounds)

    def plan_records(self, ids: np.ndarray, record_bytes: int) -> DecodePlan:
        """Fixed-size records: arithmetic spans, no index needed."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0
                         or (int(ids.max()) + 1) * record_bytes
                         > self.raw_size):
            raise IndexError(
                f"record id out of range for {self.raw_size}-byte archive: "
                f"{int(ids.min())}..{int(ids.max())} × {record_bytes}B")
        starts, lengths = pad_pow2_spans(
            ids * record_bytes,
            np.full(ids.size, record_bytes, np.int64))
        return DecodePlan(
            starts=starts, lengths=lengths, n_queries=ids.size,
            block_size=self.block_size, n_blocks=self.n_blocks,
            max_len=record_bytes,
            max_span=record_bytes // self.block_size + 2,
            max_depth=self.max_depth, block_rounds=self.block_rounds)

    def plan_spans(self, starts: np.ndarray, lengths: np.ndarray,
                   max_len: Optional[int] = None) -> DecodePlan:
        """Raw absolute byte spans (ByteRange batches).

        `max_len` widens the padded output geometry past the batch's
        longest span (a block-quantized bound for `decode_range`)."""
        starts = np.asarray(starts, np.int64).reshape(-1)
        lengths = np.asarray(lengths, np.int64).reshape(-1)
        if starts.size:
            if starts.min() < 0 or (starts + lengths).max() > self.raw_size:
                raise IndexError(
                    f"byte span out of range [0, {self.raw_size})")
            if lengths.min() < 0:
                raise IndexError("negative-length byte span")
        n = starts.size
        if max_len is None:
            max_len = max(1, int(lengths.max(initial=1)))
        elif lengths.size and max_len < int(lengths.max()):
            raise ValueError(
                f"max_len={max_len} below longest span {int(lengths.max())}")
        b0 = starts // self.block_size
        end_blk = -(-(starts + lengths) // self.block_size)
        max_span = max(1, int((end_blk - b0).max(initial=1)))
        starts, lengths = pad_pow2_spans(starts, lengths)
        return DecodePlan(
            starts=starts, lengths=lengths, n_queries=n,
            block_size=self.block_size, n_blocks=self.n_blocks,
            max_len=max_len, max_span=max_span, max_depth=self.max_depth,
            block_rounds=self.block_rounds)

    # -------------------------------------------------------------- general
    def resolve(self, addrs: Sequence[Address]
                ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Read-id and byte-range addresses → (starts i64[B], lengths
        i64[B], whole-record ids or None)."""
        typed = [normalize(a) for a in addrs]
        starts64 = self.store._starts64
        idx = self.store.index
        starts = np.zeros(len(typed), np.int64)
        lengths = np.zeros(len(typed), np.int64)
        ids = np.zeros(len(typed), np.int64)
        whole = True
        for i, a in enumerate(typed):
            if isinstance(a, Region):
                raise NotImplementedError(
                    "Region addresses need the device name table, which "
                    "comes with a later slice of the PyTorch port")
            if isinstance(a, ByteRange):
                if not 0 <= a.lo <= a.hi <= self.raw_size:
                    raise IndexError(
                        f"byte range [{a.lo}, {a.hi}) outside "
                        f"[0, {self.raw_size})")
                starts[i], lengths[i] = a.lo, a.hi - a.lo
                whole = False
                continue
            if idx is None:
                raise ValueError("read-id addresses require a ReadIndex")
            if not 0 <= a.i < idx.n_reads:
                raise IndexError(
                    f"read id {a.i} out of range [0, {idx.n_reads})")
            s, e = int(starts64[a.i]), int(starts64[a.i + 1])
            starts[i], lengths[i] = s, e - s
            ids[i] = a.i
        return starts, lengths, (ids if whole and typed else None)

    def plan(self, addrs: Sequence[Address]) -> DecodePlan:
        """The general entry: any mix of read ids and byte ranges → one
        DecodePlan. Pure whole-record batches keep the device start-table
        fast path; span batches quantize the padded width to a block
        multiple."""
        if isinstance(addrs, np.ndarray) and addrs.dtype.kind in "iu":
            return self.plan_read_ids(addrs)
        starts, lengths, ids = self.resolve(addrs)
        if ids is not None:
            return self.plan_read_ids(ids)
        quant = -(-max(1, int(lengths.max(initial=1)))
                  // self.block_size) * self.block_size
        return self.plan_spans(starts, lengths, max_len=quant)
