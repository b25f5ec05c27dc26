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
`DeviceExecutor`). The decoded-block cache and mesh-partitioned
residency come with later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.decoder import (Decoder, DeviceArchive, _decode_sel_core,
                                      _not_in_slice, check_on_error)
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
def _gather_reads_core(rows: torch.Tensor, row_map: torch.Tensor,
                       local: torch.Tensor, lengths: torch.Tensor,
                       block_size: int, max_len: int) -> torch.Tensor:
    """(U, block_size) decoded rows + per-read covering-row map → padded
    (B, max_len) u8. The ragged gather: each read pulls its bytes out of
    its covering rows at its in-block offset; beyond-length tail is 0."""
    B, span = row_map.shape
    flat = rows[row_map.long()].reshape(B, span * block_size)
    j = torch.arange(max_len, device=rows.device)[None, :]
    cols = (local.long()[:, None] + j).clamp(max=span * block_size - 1)
    out = torch.gather(flat, 1, cols)
    return torch.where(j < lengths.long()[:, None], out, 0)


def _fetch_dev_core(da: DeviceArchive, b0: torch.Tensor, local: torch.Tensor,
                    lengths: torch.Tensor, end_blk: torch.Tensor,
                    geom: tuple) -> torch.Tensor:
    """Device-side tail of the pipeline: covering blocks → unique selection
    decode (one launch at the archive-wide round count) → ragged gather.
    geom = (block_size, n_blocks, max_len, max_span).

    The reference pads the unique set to a static bound so a jitted trace
    sees one shape; eager PyTorch has no trace to bound, so exactly the
    unique covering blocks decode."""
    block_size, n_blocks, max_len, max_span = geom
    b0 = b0.long()
    blocks = b0[:, None] + torch.arange(max_span, device=b0.device)[None, :]
    # slots past a read's last covering block collapse onto its first
    # block, so they dedup away instead of decoding strangers
    blocks = torch.where(blocks < end_blk.long()[:, None], blocks,
                         b0[:, None]).clamp(0, n_blocks - 1)
    uniq, inv = torch.unique(blocks.reshape(-1), return_inverse=True)
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
    raises. `verify=True` digest-checks every decoded block (the staged
    path), raising `BlockDigestError` on a mismatch.
    """

    def __init__(self, archive: Archive, index: Optional[ReadIndex] = None,
                 device="cuda", cache_blocks: int = 0, verify: bool = False,
                 on_error: str = "raise"):
        if cache_blocks:
            raise _not_in_slice("the decoded-block cache (cache_blocks > 0)",
                                "block-cache")
        self.on_error = check_on_error(on_error)
        self.decoder = Decoder(archive, device=device)
        self.device = self.decoder.device
        self.index = index
        self.block_size = archive.block_size
        self.verify = bool(verify)
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

    # -------------------------------------------------------------- lookups
    def fetch_reads(self, ids: Sequence[int], mode2: bool = True,
                    verify: Optional[bool] = None,
                    on_error: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched variable-length random access.

        (B,) read ids → ((B, max_read_len) u8 zero-padded reads,
        (B,) i32 lengths), both on the device, in one selection decode.
        Requires a ReadIndex."""
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
