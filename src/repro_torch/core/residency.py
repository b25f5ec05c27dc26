"""Compressed-resident store (paper §4, "compressed-resident genomics").

The archive lives in device memory *compressed*; any region decodes on
demand without touching the rest. The consumer is device-resident, so
decoded bytes never cross the host link.

Batched random access (`fetch_reads`) is the serving / data-pipeline entry
point: N read ids — arbitrary, variable-length FASTQ reads — flow through
ONE pipeline:

    ids → start-table lookup (device-resident, int32 block + in-block
    offset pairs: lossless for ≥ 2 GiB archives where a flat int32 table
    truncates) → covering-block computation → unique-block selection
    decode → ragged per-read gather into a padded (B, max_len) byte matrix
    plus a length vector

entirely on the device. `fetch_read` (single read), `fetch_block_range`
and `fetch_records` (fixed-size records) are views over the same
pipeline, lowered through the query plane (`QueryPlanner` →
`DeviceExecutor`). An optional decoded-block cache
(`repro_torch.api.cache.BlockCache`: a preallocated device buffer +
CachePlan hit/miss split, pluggable policies) makes hot blocks skip
re-decode across calls. `attach_sharded` partitions the compressed
archive across a device mesh (`ShardedResidency`), each shard holding
only its block range's payload slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.decoder import (BlockDigestError, Decoder, DeviceArchive,
                                      _decode_sel_core, _decode_window_core,
                                      _pad_pow2)
from repro_torch.core.format import Archive
from repro_torch.core.index import ReadIndex, split_starts
from repro_torch.resilience import check_on_error


def _cache_off() -> dict:
    """The keys of `BlockCache.info()`, all zero: callers read the
    counters without checking whether a cache is on."""
    return {"capacity": 0, "resident": 0, "hits": 0, "misses": 0,
            "evictions": 0, "installs": 0, "coinstalls": 0,
            "bytes_resident": 0, "buffer_bytes": 0,
            "decode_launches": 0, "policy": "off"}


@dataclasses.dataclass
class ResidencyStats:
    compressed_device_bytes: int
    raw_size: int
    n_blocks: int

    @property
    def residency_fraction_of_raw(self) -> float:
        return self.compressed_device_bytes / max(1, self.raw_size)


# --------------------------------------------------------------- device core
# elements of the gather's index per pass: bounds the int64 index (and
# the mask) of a large gather, such as a streaming chunk, to 128 MiB
_GATHER_SLAB = 1 << 24


@obs.spanned("gather")
def _gather_reads_core(rows: torch.Tensor, row_map: torch.Tensor,
                       local: torch.Tensor, lengths: torch.Tensor,
                       block_size: int, max_len: int) -> torch.Tensor:
    """(U, block_size) decoded rows + per-read covering-row map → padded
    (B, max_len) u8. The ragged gather: each read pulls its bytes out of
    its covering rows at its in-block offset; beyond-length tail is 0.
    Columns go in slabs of at most `_GATHER_SLAB` elements, so the index
    of a chunk-sized gather never outgrows the chunk."""
    B, span = row_map.shape
    flat = rows[row_map.long()].reshape(B, span * block_size)
    out = torch.empty((B, max_len), dtype=torch.uint8, device=rows.device)
    local, lengths = local.long()[:, None], lengths.long()[:, None]
    step = max(1, _GATHER_SLAB // max(B, 1))
    for c0 in range(0, max_len, step):
        j = torch.arange(c0, min(c0 + step, max_len),
                         device=rows.device)[None, :]
        cols = (local + j).clamp(max=span * block_size - 1)
        out[:, c0:c0 + j.shape[1]] = torch.where(
            j < lengths, torch.gather(flat, 1, cols), 0)
    return out


def _fetch_dev_core(da: DeviceArchive, b0: torch.Tensor, local: torch.Tensor,
                    lengths: torch.Tensor, end_blk: torch.Tensor,
                    geom: tuple) -> torch.Tensor:
    """Device-side tail of the pipeline: covering blocks → unique selection
    decode (one launch at the archive-wide round count) → ragged gather.
    geom = (block_size, n_blocks, max_len, max_span).

    The reference pads the unique set to a static bound so a jitted trace
    sees one shape; eager PyTorch has no trace to bound, so exactly the
    unique covering blocks decode. Anchor-free global archives decode the
    whole prefix, as the reference's fused path does (anchored ones take
    the staged path, window by window)."""
    block_size, n_blocks, max_len, max_span = geom
    b0 = b0.long()
    blocks = b0[:, None] + torch.arange(max_span, device=b0.device)[None, :]
    # slots past a read's last covering block collapse onto its first
    # block, so they dedup away instead of decoding strangers
    blocks = torch.where(blocks < end_blk.long()[:, None], blocks,
                         b0[:, None]).clamp(0, n_blocks - 1)
    with obs.span("cover_sync"):
        # the covering set's size is read back: the host waits here
        uniq, inv = torch.unique(blocks.reshape(-1), return_inverse=True)
    obs.count("host_syncs")
    obs.count("blocks.covered", uniq.numel())
    if da.mode == "global":
        rows = _decode_window_core(da, 0, n_blocks - 1, da.max_depth)[uniq]
    else:
        rows = _decode_sel_core(da, uniq, da.max_depth)
    row_map = inv.reshape(b0.shape[0], max_span)
    return _gather_reads_core(rows, row_map, local, lengths, block_size,
                              max_len)


def _fetch_reads_core(da: DeviceArchive, starts_blk: torch.Tensor,
                      starts_rem: torch.Tensor, ids: torch.Tensor,
                      geom: tuple) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids → (padded reads, lengths), start-table lookup on the device."""
    block_size = geom[0]
    ids = ids.long()
    b0 = starts_blk[ids]
    r0 = starts_rem[ids]
    b1 = starts_blk[ids + 1]
    r1 = starts_rem[ids + 1]
    lengths = (b1 - b0) * block_size + (r1 - r0)
    end_blk = b1 + (r1 > 0).to(torch.int32)     # exclusive covering end
    out = _fetch_dev_core(da, b0, r0, lengths, end_blk, geom)
    return out, lengths


class CompressedResidentStore:
    """Archive + index resident on the device; decode-on-demand reads.

    `device` defaults to the card ("cuda"); without one the constructor
    raises. `cache_blocks > 0` enables the device-resident decoded-block
    cache (`repro_torch.api.cache.BlockCache`): hot blocks skip re-decode
    across fetch calls, misses decode in one pow2-padded call, and
    decoded bytes never leave the device. `cache_policy` selects
    eviction/admission: "lru", "freq", "tinylfu" or an `EvictionPolicy`
    instance. Mode 1 fetches (`mode2=False`) run the staged path.
    `verify=True` digest-checks every decoded block (the staged path) and
    `on_error` picks what a mismatch does: "raise" (`BlockDigestError`),
    "repair" (parity reconstruction) or "partial" (quarantine; the
    addresses it touched are flagged in `last_corrupt`). Both are store
    defaults every fetch entry point can override per call.
    """

    def __init__(self, archive: Archive, index: Optional[ReadIndex] = None,
                 device="cuda", cache_blocks: int = 0,
                 cache_policy: Union[str, object] = "lru",
                 verify: bool = False, on_error: str = "raise"):
        self.on_error = check_on_error(on_error)
        self.decoder = Decoder(archive, device=device)
        self.device = self.decoder.device
        self.index = index
        self.block_size = archive.block_size
        self.verify = bool(verify)
        self._cache_cap = int(cache_blocks)
        if self._cache_cap > 0:
            from repro_torch.api.cache import BlockCache
            self._cache = BlockCache(self._cache_cap, self.block_size,
                                     archive.n_blocks, policy=cache_policy,
                                     block_rounds=self.decoder.block_rounds,
                                     device=self.device)
        else:
            self._cache = None
        if index is not None:
            blk, rem = split_starts(index.starts, self.block_size)
            self._starts_blk = torch.from_numpy(blk).to(self.device)
            self._starts_rem = torch.from_numpy(rem).to(self.device)
            self._starts64 = index.starts.astype(np.int64)
            lens = np.diff(self._starts64)
            self._max_len = max(int(lens.max(initial=1)), 1)
            b0 = self._starts64[:-1] // self.block_size
            eb = -(-self._starts64[1:] // self.block_size)
            self._max_span = max(int((eb - b0).max(initial=1)), 1)
        else:
            self._starts_blk = self._starts_rem = None
            self._starts64 = None
            self._max_len = self._max_span = 1
        self._planner = self._executor = None
        # mesh-partitioned residency, attached on demand (attach_sharded)
        self.sharded: Optional["ShardedResidency"] = None

    def _api(self):
        """Lazy (planner, executor) pair — repro_torch.api imports this
        module."""
        if self._planner is None:
            from repro_torch.api.executors import DeviceExecutor
            from repro_torch.api.plan import QueryPlanner
            self._planner = QueryPlanner(self)
            self._executor = DeviceExecutor(self)
        return self._planner, self._executor

    def stats(self) -> ResidencyStats:
        return ResidencyStats(
            compressed_device_bytes=self.decoder.da.device_bytes,
            raw_size=self.decoder.da.raw_size,
            n_blocks=self.decoder.da.n_blocks,
        )

    def _any_cache(self):
        """The store's cache, else the attached partition's per-shard
        cache, else None."""
        if self._cache is not None:
            return self._cache
        return self.sharded._cache if self.sharded is not None else None

    @property
    def cache_hits(self) -> int:
        c = self._any_cache()
        return c.hits if c is not None else 0

    @property
    def cache_misses(self) -> int:
        c = self._any_cache()
        return c.misses if c is not None else 0

    def cache_info(self) -> dict:
        if self._cache is None:
            # when only the mesh-partitioned residency carries a cache,
            # its per-shard counters are the store's cache accounting
            if self._any_cache() is not None:
                return self.sharded.cache_info()
            return _cache_off()
        return self._cache.info()

    # ------------------------------------------------- sharded residency
    def attach_sharded(self, mesh, axes: Tuple[str, ...] = ("data",),
                       cache_blocks: int = 0,
                       cache_policy: Union[str, object] = "lru",
                       verify: bool = False,
                       on_error: str = "raise") -> "ShardedResidency":
        """Partition the compressed archive across `mesh` and attach the
        sharded residency plane (idempotent for a matching geometry:
        repeat calls reuse the partition and its warm per-shard cache)."""
        sr = self.sharded
        if (sr is not None and sr.part.mesh == mesh and sr.axes == axes
                and sr.cache_blocks == int(cache_blocks)
                and sr.verify == verify and sr.on_error == on_error):
            return sr
        self.sharded = ShardedResidency(
            self, mesh, axes=axes, cache_blocks=cache_blocks,
            cache_policy=cache_policy, verify=verify, on_error=on_error)
        return self.sharded

    def _rows_for_blocks(self, uniq: np.ndarray, mode2: bool,
                         verify: bool = False,
                         on_error: str = "raise") -> torch.Tensor:
        """(U,) unique block ids → (U, block_size) decoded rows, through the
        device-resident block cache when enabled. With `verify`, rows
        digest-check inside the decode (recovering per `on_error`); any
        block the decode reports corrupt (`Decoder.last_bad_blocks`) is
        invalidated from the cache right after — the CachePlan registered
        it resident BEFORE the decode, and a quarantined block's zero row
        must never be served as a hit."""
        dec = self.decoder
        base = (dec.decode_blocks if mode2
                else dec.decode_blocks_host_entropy)
        if verify:
            # an all-hit cache plan never reaches the decoder — clear the
            # per-call outcome state here so stale bad-block reports from
            # an earlier call cannot leak into this one's corrupt mask
            dec.last_bad_blocks = np.zeros(0, np.int64)
            dec.last_suspect_blocks = np.zeros(0, np.int64)
        else:
            on_error = "raise"      # as the reference: quarantine raises

        def decode(sel):
            return base(sel, verify=verify, on_error=on_error)

        if self._cache is None:
            return decode(_pad_pow2(uniq))[:uniq.size]
        if dec.da.mode != "global":
            rows = self._cache.rows_for(uniq, decode)
            if verify and dec.last_bad_blocks.size:
                self._cache.invalidate(dec.last_bad_blocks)
            return rows
        # global: a miss decode materializes whole anchor windows — the
        # window rows the CachePlan did not ask for co-install into free
        # slots, so a scan over the window is ONE decode. Collection is
        # opt-in (holding decoded windows costs device memory) and always
        # cleared before returning.
        dec.collect_window_rows = True
        dec.last_window_rows = []
        try:
            rows = self._cache.rows_for(uniq, decode)
            if verify and dec.last_bad_blocks.size:
                self._cache.invalidate(dec.last_bad_blocks)
            # a repaired block's window was collected twice (pre-repair
            # garbage first): every once-suspect block stays out of the
            # co-install, not only the finally bad ones
            bad = (dec.last_suspect_blocks if verify
                   else np.zeros(0, np.int64))
            for first, wrows in dec.last_window_rows:
                blks = np.arange(first, first + wrows.shape[0])
                good = np.flatnonzero(~np.isin(blks, bad))
                if good.size == blks.size:
                    self._cache.install_extras(blks, wrows)
                elif good.size:
                    obs.count("host_syncs")
                    self._cache.install_extras(
                        blks[good], wrows[torch.from_numpy(good).to(
                            wrows.device)])
        finally:
            dec.collect_window_rows = False
            dec.last_window_rows = []
        return rows

    @property
    def last_corrupt(self) -> np.ndarray:
        """Per-address corrupt mask of the most recent executor run
        (bool[B]; all False unless on_error="partial" met unrecoverable
        blocks)."""
        if self._executor is None:
            return np.zeros(0, bool)
        return self._executor.last_corrupt

    # -------------------------------------------------------------- lookups
    @obs.spanned("fetch_reads")
    def fetch_reads(self, ids: Sequence[int], mode2: bool = True,
                    verify: Optional[bool] = None,
                    on_error: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched variable-length random access.

        (B,) read ids → ((B, max_read_len) u8 zero-padded reads,
        (B,) i32 lengths), both on the device, in one selection decode.
        Requires a ReadIndex. `verify`/`on_error` override the store
        defaults for this call; per-read corrupt outcomes
        (on_error="partial") are in `last_corrupt` afterwards."""
        obs.count("requests")
        if self.index is None:
            raise ValueError("fetch_reads requires a ReadIndex")
        ids_np = np.asarray(ids, np.int64).reshape(-1)
        if ids_np.size == 0:
            return (torch.zeros((0, self._max_len), dtype=torch.uint8,
                                device=self.device),
                    torch.zeros((0,), dtype=torch.int32, device=self.device))
        planner, executor = self._api()
        return executor.run(planner.plan_read_ids(ids_np), mode2=mode2,
                            verify=verify, on_error=on_error)

    def fetch_read(self, r: int, mode2: bool = True) -> np.ndarray:
        """Single-read random access: the B=1 case of `fetch_reads`."""
        out, lens = self.fetch_reads(np.array([r], np.int64), mode2=mode2)
        return out[0, :int(lens[0])].cpu().numpy()

    @obs.spanned("fetch_block_range")
    def fetch_block_range(self, b0: int, b1: int, mode2: bool = True
                          ) -> torch.Tensor:
        """Position-invariant block-range decode (stays on the device):
        (b1-b0, block_size) u8 rows, tail bytes of a partial final block
        zeroed. One block-aligned span plan through the query plane."""
        obs.count("requests")
        n_blocks = self.decoder.da.n_blocks
        if not 0 <= b0 <= b1 <= n_blocks:
            raise IndexError(
                f"block range [{b0}, {b1}) outside [0, {n_blocks})")
        if b0 == b1:
            return torch.zeros((0, self.block_size), dtype=torch.uint8,
                               device=self.device)
        a = self.decoder.archive
        planner, executor = self._api()
        plan = planner.plan_spans(a.block_start[b0:b1],
                                  a.block_len[b0:b1].astype(np.int64),
                                  max_len=self.block_size)
        rows, _ = executor.run(plan, mode2=mode2)
        return rows

    @obs.spanned("fetch_records")
    def fetch_records(self, ids: Sequence[int], record_bytes: int,
                      mode2: bool = True) -> torch.Tensor:
        """Batched fixed-record fetch: (B,) ids → (B, record_bytes) u8.
        Same pipeline as `fetch_reads` with arithmetic start offsets, so it
        needs no index."""
        obs.count("requests")
        ids_np = np.asarray(ids, np.int64).reshape(-1)
        if ids_np.size == 0:
            return torch.zeros((0, record_bytes), dtype=torch.uint8,
                               device=self.device)
        planner, executor = self._api()
        out, _ = executor.run(planner.plan_records(ids_np, record_bytes),
                              mode2=mode2)
        return out


class ShardedResidency:
    """Mesh-partitioned compressed residency for one store.

    Owns the `ShardPartition` (each shard holds only its contiguous block
    range's payload slice, on its device: compressed residency scales
    with mesh width) plus, when `cache_blocks > 0`, the per-shard
    decoded-block cache (`repro_torch.api.cache.ShardedBlockCache`: every
    shard runs its own hit/miss split against its own slot tensor on its
    device). `verify=True` digest-checks every per-shard decode
    shard-locally BEFORE assembly (`BlockDigestError` names the true
    global block id).

    This is the residency plane `ShardedExecutor` and `StreamingExecutor`
    ride; shard-aware work composes here and at `CachePlan`, never inside
    the executors themselves.
    """

    def __init__(self, store: CompressedResidentStore, mesh,
                 axes: Tuple[str, ...] = ("data",), cache_blocks: int = 0,
                 cache_policy: Union[str, object] = "lru",
                 verify: bool = False, on_error: str = "raise"):
        from repro_torch.core.sharded_decode import partition_archive
        self.store = store
        self.decoder = store.decoder
        self.axes = tuple(axes)
        self.verify = verify
        self.on_error = check_on_error(on_error)
        # partition rebuilds performed by the recovery path (payload
        # corruption healed on the flat copy, or a lost shard re-seeded)
        self.shard_rebuilds = 0
        self.cache_blocks = int(cache_blocks)
        self.part = partition_archive(store.decoder, mesh, self.axes)
        if self.cache_blocks > 0:
            from repro_torch.api.cache import ShardedBlockCache
            self._cache = ShardedBlockCache(
                self.cache_blocks, store.block_size, self.part.n_blocks,
                self.part, policy=cache_policy,
                block_rounds=store.decoder.block_rounds,
                device=store.device)
        else:
            self._cache = None

    # ----------------------------------------------------------- accounting
    def per_shard_bytes(self) -> int:
        """Device-resident bytes on ONE shard: its compressed payload
        slice plus its slot tensor of the decoded-block cache."""
        tot = self.part.per_shard_device_bytes
        if self._cache is not None:
            tot += self._cache.per_shard_buffer_bytes
        return tot

    def device_bytes(self) -> int:
        """Total device-resident bytes across the mesh (what a serving
        budget bounds): the sum of every shard's compressed + cache
        bytes."""
        return self.part.n_shards * self.per_shard_bytes()

    def cache_info(self) -> dict:
        return _cache_off() if self._cache is None else self._cache.info()

    # ------------------------------------------------------------- recovery
    def _quarantine_hit(self, uniq: np.ndarray) -> bool:
        q = self.decoder.quarantined
        return bool(q) and bool(
            np.isin(uniq, np.fromiter(q, np.int64, len(q))).any())

    def _degraded_rows(self, uniq: np.ndarray,
                       pad: bool = True) -> torch.Tensor:
        """Partial-failure fallback: serve through the UNPARTITIONED
        decoder with partial semantics (quarantined blocks read zeros,
        nothing installs into the sharded cache)."""
        sel = _pad_pow2(uniq) if pad else uniq
        return self.decoder.decode_blocks(sel, verify=True,
                                          on_error="partial",
                                          pad_groups=pad)[:uniq.size]

    def _heal_and_rebuild(self, uniq: np.ndarray, on_error: str) -> None:
        """A partitioned decode failed its shard-local digest check.
        Recovery composes HERE, at the residency layer: heal on the
        UNPARTITIONED decoder — parity reconstruction patches the flat
        device words and the host archive, or proves the flat copy was
        never corrupt (a lost shard) — then re-seed the partition's
        tensors from the healed host copy, in place, so the per-shard
        cache and its slot tensors stay valid."""
        dec = self.decoder
        try:
            dec.decode_blocks(_pad_pow2(uniq), verify=True,
                              on_error=("repair" if on_error == "repair"
                                        else "partial"))
        except BlockDigestError:
            if on_error != "partial":
                raise
        self.part.reseed(dec.archive)
        self.shard_rebuilds += 1

    def _resilient(self, run, uniq: np.ndarray, on_error: str,
                   pad: bool = True) -> torch.Tensor:
        """Run a verified partitioned decode with heal-and-rebuild retry
        (one retry: a second failure means genuinely unrecoverable)."""
        if on_error == "partial" and self._quarantine_hit(uniq):
            return self._degraded_rows(uniq, pad=pad)
        try:
            return run()
        except BlockDigestError:
            if on_error == "raise":
                raise
            self._heal_and_rebuild(uniq, on_error)
            if on_error == "partial" and self._quarantine_hit(uniq):
                return self._degraded_rows(uniq, pad=pad)
            return run()

    # ----------------------------------------------------------------- rows
    def rows_for_blocks(self, uniq: np.ndarray,
                        on_error: Optional[str] = None) -> torch.Tensor:
        """(U,) unique global block ids → (U, block_size) rows on the
        store's device, through the partitioned archive (and the
        per-shard cache when enabled). Resets the decoder's per-call
        counters as `decode_blocks` does."""
        dec = self.decoder
        dec.launch_rounds_last = []
        dec.decoded_blocks_last = 0
        on_error = self.on_error if on_error is None else on_error
        uniq = np.asarray(uniq, np.int64).reshape(-1)
        if self._cache is None:
            run = lambda: self._decode_uncached(uniq)  # noqa: E731
        else:
            run = lambda: self._cache.rows_for(  # noqa: E731
                uniq, self._decode_stacked)
        if not self.verify or on_error == "raise":
            return run()
        return self._resilient(run, uniq, on_error)

    def stream_rows(self, uniq: np.ndarray, verify: bool,
                    on_error: str) -> torch.Tensor:
        """Cache-bypassing exact-size decode with the recovery wrapper —
        the streaming executor's entry point (it never recovers
        itself)."""
        uniq = np.asarray(uniq, np.int64).reshape(-1)
        run = lambda: self._decode_uncached(  # noqa: E731
            uniq, pad=False, verify=verify)
        if not verify or on_error == "raise":
            return run()
        return self._resilient(run, uniq, on_error, pad=False)

    def _decode_stacked(self, loc: np.ndarray, n_rounds: int,
                        valid: np.ndarray) -> list:
        """The per-shard miss decode the sharded cache drives: one decode
        a shard at this depth bucket's rounds → per-shard rows (None for
        a shard with no miss in the bucket). Pad slots (`~valid`) may hold
        garbage under a shallow bucket's rounds — verification masks
        them; the cache install drops them."""
        from repro_torch.core.sharded_decode import (_rounds,
                                                     partitioned_rows,
                                                     verify_stacked)
        dec = self.decoder
        stacked = partitioned_rows(dec, self.part, loc, n_rounds=n_rounds,
                                   valid=valid)
        dec.launch_rounds_last.append(_rounds(dec, n_rounds))
        dec.decoded_blocks_last += int(loc.shape[1])
        if self.verify:
            verify_stacked(dec, self.part, stacked, loc, valid=valid)
        return stacked

    def _decode_uncached(self, uniq: np.ndarray, pad: bool = True,
                         verify: Optional[bool] = None) -> torch.Tensor:
        """Cache-bypassing partitioned decode, depth-bucketed: one
        per-shard decode per scheduled-rounds group (`pad=False` keeps
        exact per-shard widths — the streaming budget path, which also
        passes its own `verify` instead of this residency's default)."""
        from repro_torch.core.sharded_decode import partitioned_decode_blocks
        dec = self.decoder
        verify = self.verify if verify is None else verify
        groups = dec._ra_groups(uniq)
        if groups is None:
            return partitioned_decode_blocks(dec, self.part, uniq,
                                             verify=verify, pad=pad)
        pieces = [partitioned_decode_blocks(dec, self.part, uniq[idx],
                                            n_rounds=rounds,
                                            verify=verify, pad=pad)
                  for rounds, idx in groups]
        order = np.concatenate([idx for _, idx in groups])
        inv = np.empty(order.size, np.int64)
        inv[order] = np.arange(order.size)
        return torch.cat(pieces)[torch.from_numpy(inv).to(dec.device)]
