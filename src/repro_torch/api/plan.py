"""Query planning: any batch of addresses → one `DecodePlan`.

This module is THE place the covering-block math lives. The device-side
twin of the same arithmetic lives in `residency._fetch_dev_core` (the
fast path computes the covering set from the device start table), and
`covering_blocks` below is its host mirror — change one, change both.

A `DecodePlan` is the lowered form of a query batch: absolute byte spans,
padded batch/output geometry, and — lazily, for the staged cache/Mode-1/
anchored paths — the unique covering-block selection plus the ragged row
map the gather consumes. A `CachePlan` is its cache step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.address import (Address, ByteRange, NameTable, ReadId,
                                     Region, normalize)


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


def anchor_floor(blocks: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """Per-block governing anchor: the greatest anchor block id <= block.
    `anchors` is the archive's sorted anchor table (anchors[0] == 0);
    empty → everything falls to block 0 (whole-prefix semantics)."""
    blocks = np.asarray(blocks, np.int64)
    anchors = np.asarray(anchors, np.int64)
    if anchors.size == 0:
        return np.zeros(blocks.shape, np.int64)
    i = np.searchsorted(anchors, blocks, side="right") - 1
    return anchors[np.maximum(i, 0)]


def anchor_window_groups(sel: np.ndarray, anchors: np.ndarray) -> list:
    """Partition a block selection by governing anchor window.

    Returns [(win_first, win_last, idx)] where `idx` are positions into
    `sel` (original order kept within a group), `win_first` is the
    group's anchor and `win_last` its highest selected block — the window
    [win_first, win_last] is what a checkpointed-wavefront decode
    materializes for that group. Empty `anchors` yields one group rooted
    at block 0."""
    sel = np.asarray(sel, np.int64).reshape(-1)
    if sel.size == 0:
        return []
    gov = anchor_floor(sel, anchors)
    groups = []
    for a in np.unique(gov):
        idx = np.flatnonzero(gov == a)
        groups.append((int(a), int(sel[idx].max()), idx))
    return groups


def split_shards(blocks: np.ndarray, bounds: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Global block ids → (owning shard, shard-local id) under a
    contiguous block partition. `bounds` is the i64[n_shards + 1]
    boundary table of a `ShardPartition` (bounds[s] .. bounds[s+1] is
    shard s's range). THE host implementation of the shard coordinate
    map — the residency, cache and executor layers all route through
    here."""
    blocks = np.asarray(blocks, np.int64).reshape(-1)
    bounds = np.asarray(bounds, np.int64)
    shard = np.searchsorted(bounds[1:], blocks, side="right")
    return shard, blocks - bounds[shard]


def shard_selection(shard: np.ndarray, local: np.ndarray, n_shards: int,
                    pad: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lower a per-shard split to the per-shard decode geometry:

      loc      (n_shards, S) i32 — shard-local ids, row s holding shard
               s's selections left-packed; pad slots select local id 0
      flat_idx i64[n] — position of each input element in the flattened
               (n_shards * S) shard-major decode output (the assembly
               gather)
      valid    bool(n_shards, S) — False on pad slots (verify masks them:
               a pad row decoded under a shallow bucket's rounds may be
               garbage, and it is never read)

    S is the max per-shard count, pow2-padded unless `pad=False` (the
    streaming budget path keeps exact sizes)."""
    shard = np.asarray(shard, np.int64)
    local = np.asarray(local, np.int64)
    counts = np.bincount(shard, minlength=n_shards)
    S = int(counts.max(initial=1))
    if pad:
        S = 1 << max(0, S - 1).bit_length()
    loc = np.zeros((n_shards, S), np.int32)
    valid = np.zeros((n_shards, S), bool)
    order = np.argsort(shard, kind="stable")
    group_first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos_sorted = np.arange(shard.size) - group_first[shard[order]]
    loc[shard[order], pos_sorted] = local[order]
    valid[shard[order], pos_sorted] = True
    flat_idx = np.empty(shard.size, np.int64)
    flat_idx[order] = shard[order] * S + pos_sorted
    return loc, flat_idx, valid


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

    @property
    def u_cap(self) -> int:
        """Bound on the covering set's size: `max_span` blocks a span,
        at most the archive's blocks."""
        return min(self.batch * self.max_span, self.n_blocks)

    def geom(self) -> tuple:
        """(block_size, n_blocks, max_len, max_span). The reference's
        tuple adds `u_cap`, the static width of its jitted covering set;
        the port's fetch core sizes that set on the device and unpacks
        these four."""
        return (self.block_size, self.n_blocks, self.max_len, self.max_span)

    @property
    def total_payload_bytes(self) -> int:
        return int(self.lengths[:self.n_queries].sum())

    @property
    def padded_output_bytes(self) -> int:
        return self.batch * self.max_len

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

    def n_cover_blocks(self) -> int:
        """Unique covering blocks of this plan: the decode-work unit the
        serving frontend's service-time estimator prices dispatches in."""
        return int(self.host_cover()[3].size)

    def anchor_windows(self, anchors: np.ndarray) -> list:
        """This plan's covering set grouped by governing anchor window:
        [(win_first, win_last, idx-into-uniq)]. A checkpointed-wavefront
        execution decodes sum(win_last - win_first + 1) blocks."""
        _, _, _, uniq, _ = self.host_cover()
        return anchor_window_groups(uniq, anchors)

    def anchor_decode_blocks(self, anchors: np.ndarray) -> int:
        """Blocks a global decode of this plan touches: the summed anchor
        windows (one window rooted at block 0 when `anchors` is empty)."""
        return sum(last - first + 1
                   for first, last, _ in self.anchor_windows(anchors))

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

    # ---------------------------------------------------------- shard split
    def shard_cover(self, bounds: np.ndarray) -> tuple:
        """(shard, local) split of this plan's unique covering set under
        the contiguous block partition `bounds`."""
        _, _, _, uniq, _ = self.host_cover()
        return split_shards(uniq, bounds)

    def needed_rounds(self) -> Optional[int]:
        """Max scheduled rounds over the covering set — strictly below
        `max_depth` exactly when the whole selection avoids the archive's
        deepest bucket."""
        if self.block_rounds is None:
            return None
        _, _, _, uniq, _ = self.host_cover()
        return int(self.block_rounds[uniq].max(initial=0))


@dataclasses.dataclass
class CachePlan:
    """The cache step of a DecodePlan: its unique covering set split into
    cache-resident hits and a miss set, with the slots the admitted
    misses install into. Produced by `BlockCache.plan`
    (`repro_torch.api.cache`) with vectorized numpy and consumed by one
    decode call over the pow2-padded miss set plus one install/gather."""
    uniq: np.ndarray            # i64[U] unique covering block ids
    src_is_miss: np.ndarray     # bool[U]: row comes from the miss decode
    src_idx: np.ndarray         # i32[U]: cache slot (hit) | miss row (miss)
    miss_blocks: np.ndarray     # i64[M] blocks needing decode
    install_slots: np.ndarray   # i32[M]: slot per miss; == capacity when
                                # the policy did not admit the block
    n_hits: int
    n_misses: int
    n_installed: int
    n_evicted: int
    miss_groups: Optional[list] = None  # [(n_rounds, idx-into-miss_blocks)]
                                # ascending — the miss set by scheduled
                                # resolve rounds (None = legacy archive)

    @property
    def n_uniq(self) -> int:
        return int(self.uniq.size)


def split_cache_hits(uniq: np.ndarray, slot_of: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized hit/miss split of a covering set against a block-id →
    slot map (-1 = absent): returns (hit_mask bool[U], slots i32[U])."""
    slots = slot_of[np.asarray(uniq, np.int64)]
    return slots >= 0, slots


class QueryPlanner:
    """Lowers any batch of addresses to a single DecodePlan.

    Works over a `CompressedResidentStore` (or the bare-decoder adapter in
    `repro_torch.api.executors`); Region addresses additionally need a
    `NameTable`.
    """

    def __init__(self, store, name_table: Optional[NameTable] = None):
        self.store = store
        self.name_table = name_table
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
        """Addresses → (starts i64[B], lengths i64[B], whole-record ids or
        None). Region names resolve through the device name table in at
        most two batched lookups (a full-string pre-pass, then only the
        parse-produced names). Strings follow samtools precedence: the FULL
        string is tried as a record name first, so Illumina-style names
        ending in numeric `:x:y` fields resolve whole-record before any
        `:start-end` suffix is read as coordinates."""
        typed = list(addrs)
        rid_at = {}                    # address index → resolved read id
        strs = [(i, a.encode() if isinstance(a, str) else bytes(a))
                for i, a in enumerate(typed)
                if isinstance(a, (str, bytes))]
        if strs and self.name_table is not None:
            hit = self.name_table.lookup([s for _, s in strs],
                                         missing_ok=True)
            for (i, s), rid in zip(strs, hit):
                if rid >= 0:           # full-string name hit: keep the id
                    typed[i] = Region(s)
                    rid_at[i] = int(rid)
                else:
                    typed[i] = normalize(s)
        typed = [normalize(a) for a in typed]
        pending = [(i, a) for i, a in enumerate(typed)
                   if isinstance(a, Region) and i not in rid_at]
        if pending:
            if self.name_table is None:
                raise ValueError(
                    "Region addresses require a NameTable (build the "
                    "archive with names, e.g. GenomicArchive.from_bytes)")
            looked = self.name_table.lookup([a.name for _, a in pending])
            rid_at.update((i, int(r)) for (i, _), r in zip(pending, looked))

        starts64 = self.store._starts64
        idx = self.store.index
        starts = np.zeros(len(typed), np.int64)
        lengths = np.zeros(len(typed), np.int64)
        ids = np.zeros(len(typed), np.int64)
        whole = True
        for i, a in enumerate(typed):
            if isinstance(a, ByteRange):
                if not 0 <= a.lo <= a.hi <= self.raw_size:
                    raise IndexError(
                        f"byte range [{a.lo}, {a.hi}) outside "
                        f"[0, {self.raw_size})")
                starts[i], lengths[i] = a.lo, a.hi - a.lo
                whole = False
                continue
            if isinstance(a, ReadId):
                if idx is None:
                    raise ValueError("read-id addresses require a ReadIndex")
                if not 0 <= a.i < idx.n_reads:
                    raise IndexError(
                        f"read id {a.i} out of range [0, {idx.n_reads})")
                rid = a.i
                lo, hi = 0, None
            else:                                   # Region
                rid = rid_at[i]
                lo, hi = a.start or 0, a.end
            s, e = int(starts64[rid]), int(starts64[rid + 1])
            if hi is None:
                hi = e - s
            if not 0 <= lo <= hi <= e - s:
                raise IndexError(
                    f"region [{lo}, {hi}) outside record {rid} "
                    f"({e - s} bytes)")
            starts[i], lengths[i] = s + lo, hi - lo
            ids[i] = rid
            whole = whole and lo == 0 and hi == e - s
        return starts, lengths, (ids if whole and typed else None)

    def plan(self, addrs: Sequence[Address]) -> DecodePlan:
        """The general entry: any mix of addresses → one DecodePlan. Pure
        whole-record batches keep the device start-table fast path; span
        batches quantize the padded width to a block multiple."""
        if isinstance(addrs, np.ndarray) and addrs.dtype.kind in "iu":
            return self.plan_read_ids(addrs)
        starts, lengths, ids = self.resolve(addrs)
        if ids is not None:
            return self.plan_read_ids(ids)
        quant = -(-max(1, int(lengths.max(initial=1)))
                  // self.block_size) * self.block_size
        return self.plan_spans(starts, lengths, max_len=quant)
