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
re-decode across calls. Mesh-partitioned residency comes with a later
slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.decoder import (Decoder, DeviceArchive, _decode_sel_core,
                                      _decode_window_core, _pad_pow2,
                                      check_on_error)
from repro_torch.core.format import Archive
from repro_torch.core.index import ReadIndex, split_starts


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
    uniq, inv = torch.unique(blocks.reshape(-1), return_inverse=True)
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
    `verify=True` digest-checks every decoded block (the staged path),
    raising `BlockDigestError` on a mismatch.
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

    @property
    def cache_hits(self) -> int:
        return self._cache.hits if self._cache is not None else 0

    @property
    def cache_misses(self) -> int:
        return self._cache.misses if self._cache is not None else 0

    def cache_info(self) -> dict:
        if self._cache is None:
            # the keys of BlockCache.info(), all zero — callers read the
            # counters without checking whether the cache is on
            return {"capacity": 0, "resident": 0, "hits": 0, "misses": 0,
                    "evictions": 0, "installs": 0, "coinstalls": 0,
                    "bytes_resident": 0, "buffer_bytes": 0,
                    "decode_launches": 0, "policy": "off"}
        return self._cache.info()

    def _rows_for_blocks(self, uniq: np.ndarray, mode2: bool,
                         verify: bool = False,
                         on_error: str = "raise") -> torch.Tensor:
        """(U,) unique block ids → (U, block_size) decoded rows, through the
        device-resident block cache when enabled; `verify` digest-checks
        the rows inside the decode."""
        dec = self.decoder
        base = (dec.decode_blocks if mode2
                else dec.decode_blocks_host_entropy)

        def decode(sel):
            return base(sel, verify=verify, on_error=on_error)

        if self._cache is None:
            return decode(_pad_pow2(uniq))[:uniq.size]
        if dec.da.mode != "global":
            return self._cache.rows_for(uniq, decode)
        # global: a miss decode materializes whole anchor windows — the
        # window rows the CachePlan did not ask for co-install into free
        # slots, so a scan over the window is ONE decode. Collection is
        # opt-in (holding decoded windows costs device memory) and always
        # cleared before returning.
        dec.collect_window_rows = True
        dec.last_window_rows = []
        try:
            rows = self._cache.rows_for(uniq, decode)
            for first, wrows in dec.last_window_rows:
                self._cache.install_extras(
                    np.arange(first, first + wrows.shape[0]), wrows)
        finally:
            dec.collect_window_rows = False
            dec.last_window_rows = []
        return rows

    # -------------------------------------------------------------- lookups
    def fetch_reads(self, ids: Sequence[int], mode2: bool = True,
                    verify: Optional[bool] = None,
                    on_error: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched variable-length random access.

        (B,) read ids → ((B, max_read_len) u8 zero-padded reads,
        (B,) i32 lengths), both on the device, in one selection decode.
        Requires a ReadIndex. `verify`/`on_error` override the store
        defaults for this call."""
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

    def fetch_block_range(self, b0: int, b1: int, mode2: bool = True
                          ) -> torch.Tensor:
        """Position-invariant block-range decode (stays on the device):
        (b1-b0, block_size) u8 rows, tail bytes of a partial final block
        zeroed. One block-aligned span plan through the query plane."""
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

    def fetch_records(self, ids: Sequence[int], record_bytes: int,
                      mode2: bool = True) -> torch.Tensor:
        """Batched fixed-record fetch: (B,) ids → (B, record_bytes) u8.
        Same pipeline as `fetch_reads` with arithmetic start offsets, so it
        needs no index."""
        ids_np = np.asarray(ids, np.int64).reshape(-1)
        if ids_np.size == 0:
            return torch.zeros((0, record_bytes), dtype=torch.uint8,
                               device=self.device)
        planner, executor = self._api()
        out, _ = executor.run(planner.plan_records(ids_np, record_bytes),
                              mode2=mode2)
        return out
