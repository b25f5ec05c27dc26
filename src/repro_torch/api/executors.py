"""Plan executors: how a DecodePlan becomes bytes.

DeviceExecutor     — entropy decode → match resolve → ragged gather, on
                     the device (`_fetch_dev_core` underneath). Whole-record
                     plans resolve their covering set from the device start
                     table (`_fetch_reads_core`). Anchored global archives,
                     the block cache, Mode 1, verified runs and plans whose
                     covering set avoids the archive's deepest depth bucket
                     take the staged variant: host covering set from the
                     plan, rows from the store (cache, one decode per miss
                     set and depth bucket, window by window for anchored
                     archives), the same gather.
StreamingExecutor  — a VRAM-budgeted chunked iterator over a plan: the
                     paper's §5 range decode generalized, so ANY query
                     streams in chunks of `max_resident_bytes` accounted
                     bytes, at a device peak that does not grow with the
                     query's size.

The sharded executor comes with the multi-GPU slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.address import Address
from repro_torch.api.plan import DecodePlan, QueryPlanner, anchor_floor
from repro_torch.core.decoder import _not_in_slice, _pad_pow2, check_on_error
from repro_torch.core.residency import (_fetch_dev_core, _fetch_reads_core,
                                        _gather_reads_core)


class _DecoderStore:
    """Minimal store adapter so a bare `Decoder` rides the query plane
    (no index, no cache) without duplicating its device archive."""

    index = None
    _starts64 = None
    _cache_cap = 0
    verify = False
    on_error = "raise"

    def __init__(self, decoder):
        self.decoder = decoder
        self.block_size = decoder.da.block_size

    def _rows_for_blocks(self, uniq: np.ndarray, mode2: bool,
                         verify: bool = False,
                         on_error: str = "raise") -> torch.Tensor:
        decode = (self.decoder.decode_blocks if mode2
                  else self.decoder.decode_blocks_host_entropy)
        return decode(_pad_pow2(uniq), verify=verify,
                      on_error=on_error)[:uniq.size]


def _dev(x: np.ndarray, device, dtype=np.int64) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)


def _gather_plan(rows: torch.Tensor, plan: DecodePlan) -> torch.Tensor:
    """The ragged gather of a plan's padded span batch out of its unique
    covering rows → (plan.batch, plan.max_len) u8."""
    _, r0, _, _, row_map = plan.host_cover()
    dev = rows.device
    return _gather_reads_core(rows, _dev(row_map, dev), _dev(r0, dev),
                              _dev(plan.lengths, dev),
                              block_size=plan.block_size,
                              max_len=plan.max_len)


class DeviceExecutor:
    """Execute a DecodePlan on the store's device pipeline.

    Returns ((n_queries, max_len) u8 zero-padded rows, (n_queries,) i32
    lengths), both on the device. `last_corrupt` is the per-address
    corrupt mask of the most recent run: all False under
    `on_error="raise"`, which raises instead.
    """

    def __init__(self, store):
        self.store = store
        self.last_corrupt = np.zeros(0, bool)

    def run(self, plan: DecodePlan, mode2: bool = True,
            verify: Optional[bool] = None, on_error: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        store = self.store
        verify = store.verify if verify is None else verify
        on_error = check_on_error(store.on_error if on_error is None
                                  else on_error)
        dec = store.decoder
        dev = dec.device
        B = plan.n_queries
        self.last_corrupt = np.zeros(B, bool)
        if B == 0:
            return (torch.zeros((0, plan.max_len), dtype=torch.uint8,
                                device=dev),
                    torch.zeros((0,), dtype=torch.int32, device=dev))
        # checkpointed-wavefront archives take the staged path: the decoder
        # groups the covering set by anchor window (a bounded decode
        # instead of the whole prefix the fused core materializes), and
        # rows ride the block cache when it is on. Verified runs are staged
        # too: the fused core has no digest check.
        anchored = dec.da.mode == "global" and dec.da.anchors.size > 0
        fused = (mode2 and store._cache_cap == 0 and not anchored
                 and not verify)
        # depth-bucketed reroute: the fused core runs the archive-wide
        # round count, so a covering set entirely below the deepest bucket
        # saves rounds only on the staged path (one launch per bucket)
        if fused and dec.multi_bucket and plan.block_rounds is not None:
            needed = plan.needed_rounds()
            if needed is not None and needed < (dec.da.max_depth or 0):
                fused = False
        if fused and plan.device_ids is not None:
            out, lens = _fetch_reads_core(
                dec.da, store._starts_blk, store._starts_rem,
                _dev(plan.device_ids, dev), plan.geom())
            return out[:B], lens[:B]
        lens = _dev(plan.lengths[:B], dev, np.int32)
        if fused:
            b0, r0, end_blk = plan.host_spans()
            out = _fetch_dev_core(
                dec.da, _dev(b0, dev), _dev(r0, dev),
                _dev(plan.lengths, dev), _dev(end_blk, dev), plan.geom())
            return out[:B], lens
        # staged: host covering set, rows from the store (block cache, one
        # decode per miss set and depth bucket, Mode 1's host entropy
        # stage), then the same ragged gather; bytes stay on the device
        uniq = plan.host_cover()[3]
        rows = store._rows_for_blocks(uniq, mode2, verify=verify,
                                      on_error=on_error)
        return _gather_plan(rows, plan)[:B], lens


@dataclasses.dataclass
class ChunkStats:
    """Per-chunk residency accounting: decoded rows + padded gather output
    are what a chunk materializes beyond the compressed archive.
    `decoded_bytes` is exact (the block selection is not pow2-padded);
    `gather_bytes` counts the pow2-padded span batch `plan_spans` makes,
    because that padded (batch, max_len) matrix is what the gather
    materializes."""
    n_spans: int
    n_blocks: int
    decoded_bytes: int        # blocks decoded * block_size: the unique
                              # covering rows for "ra", the summed anchor
                              # windows for checkpointed wavefronts
    gather_bytes: int         # padded gather output: pow2(B) * max_len
    yielded_bytes: int

    @property
    def resident_bytes(self) -> int:
        return self.decoded_bytes + self.gather_bytes


class StreamingExecutor:
    """Decode arbitrarily large queries under a byte budget.

    Spans are split at block boundaries into pieces covering at most K
    blocks (K sized so decoded rows + gather output of a chunk fit
    `max_resident_bytes`), then greedily packed into chunks; each chunk is
    one planner lowering + one device execution, yielded as exact payload
    bytes on the host. Concatenating every yielded chunk reproduces the
    concatenated payloads of the addressed spans. `chunk_log` records the
    accounting.

    The budget bounds each chunk's accounted bytes (`ChunkStats.
    resident_bytes`: decoded rows + padded gather output), exactly as the
    reference's does. It is not a cap on device memory: the decode's
    stream rows, the depth-bucket reassembly and the gather's flattened
    rows and index come on top. On an NVIDIA H100 a "ra" archive of
    16 KiB blocks streamed under 256 MiB peaked at 3.5x the budget above
    the resident archive, whatever the output size (PERF.md §5); size
    device memory by that factor, not by the budget alone.

    The block cache is bypassed (streaming scans would thrash it). The
    budget must hold the archive's atomic decode unit: one block for "ra",
    one anchor window (`(anchor_interval + 1) * block_size`) for
    checkpointed wavefronts, and the ENTIRE prefix for anchor-free global
    archives, which decode whole-prefix by construction — a smaller budget
    is rejected up front instead of being violated on the device.

    `verify=True` digest-checks each decoded block on the device before
    rows are cropped to spans, raising `BlockDigestError` naming the true
    block id. `sharded=` comes with the multi-GPU slice of the port.
    """

    def __init__(self, store, max_resident_bytes: Optional[int] = None,
                 max_blocks_per_chunk: Optional[int] = None,
                 mode2: bool = True, planner: Optional[QueryPlanner] = None,
                 verify: bool = False, sharded=None,
                 on_error: str = "raise"):
        if sharded is not None:
            raise _not_in_slice("StreamingExecutor(sharded=...)",
                                "multi-GPU residency")
        self.on_error = check_on_error(on_error)
        self.store = store
        self.planner = planner or QueryPlanner(store)
        bs = store.block_size
        da = store.decoder.da
        self._global = da.mode == "global"
        self._anchors = (da.anchors if self._global
                         else np.zeros(0, np.int64))
        # the atomic decode unit a budget must hold: one block for "ra",
        # one anchor window for checkpointed wavefronts (an interval past
        # n_blocks is one whole-archive window), the whole prefix for
        # anchor-free global archives
        if not self._global:
            interval = 0
        elif self._anchors.size:
            interval = min(da.anchor_interval, da.n_blocks)
        else:
            interval = da.n_blocks
        if max_resident_bytes is not None:
            need = max(2, interval + 1) * bs
            if max_resident_bytes < need:
                hint = ""
                if interval:
                    hint = (f" ((anchor_interval={interval} + 1) * "
                            f"block_size)" if self._anchors.size else
                            f" (anchor-free global archives decode the "
                            f"whole {da.n_blocks}-block prefix; encode "
                            f"with anchor_interval to stream under a "
                            f"smaller budget)")
                raise ValueError(
                    f"max_resident_bytes={max_resident_bytes} cannot hold "
                    f"one decode window + its output; need >= {need}"
                    + hint)
        self.max_resident_bytes = max_resident_bytes
        if max_blocks_per_chunk is None:
            if max_resident_bytes is not None:
                # anchored global: a K-block piece may decode K+interval-1
                # window blocks and gather K*bs — size K so a lone piece
                # still fits the budget
                max_blocks_per_chunk = max(
                    1, (max_resident_bytes // bs - max(interval - 1, 0)) // 2)
            else:
                max_blocks_per_chunk = da.n_blocks or 1
        self.max_blocks_per_chunk = int(max_blocks_per_chunk)
        self.mode2 = mode2
        self.verify = verify
        self.chunk_log: List[ChunkStats] = []

    # ------------------------------------------------------------- pieces
    def _pieces(self, addrs: Sequence[Address]
                ) -> Iterator[Tuple[int, int]]:
        """Resolved spans split at K-block boundaries into (start, length)
        pieces, each covering at most K blocks."""
        starts, lengths, _ = self.planner.resolve(addrs)
        bs = self.store.block_size
        K = self.max_blocks_per_chunk
        for s, ln in zip(starts.tolist(), lengths.tolist()):
            pos, end = s, s + ln
            while pos < end:
                nxt = min(end, (pos // bs + K) * bs)
                yield pos, nxt - pos
                pos = nxt

    def _piece_blocks(self, s: int, ln: int) -> set:
        """Blocks a piece's decode materializes: its covering blocks,
        widened to the governing anchor window for checkpointed
        wavefronts (a decode cannot start mid-window)."""
        bs = self.store.block_size
        b_lo, b_hi = s // bs, -(-(s + ln) // bs)
        if self._anchors.size:
            b_lo = int(anchor_floor(np.asarray([b_lo]), self._anchors)[0])
        return set(range(b_lo, b_hi))

    def chunks(self, addrs: Sequence[Address]) -> Iterator[np.ndarray]:
        """Yield u8 chunks; their concatenation == the concatenation of the
        addressed payloads, in address order."""
        bs = self.store.block_size
        budget = self.max_resident_bytes
        cur: List[Tuple[int, int]] = []
        cur_blocks: set = set()
        cur_maxlen = 0

        def pow2(n):
            return 1 << max(0, n - 1).bit_length()

        whole_prefix = self._global and not self._anchors.size
        n_blocks = self.store.decoder.da.n_blocks
        for s, ln in self._pieces(addrs):
            if whole_prefix:
                pb = set()
                nblk = n_blocks
            else:
                pb = self._piece_blocks(s, ln)
                nblk = len(cur_blocks | pb)
            # plan_spans pow2-pads the span batch, so the gather output a
            # chunk materializes is pow2(B) * max_len — cost it that way
            cost = nblk * bs + pow2(len(cur) + 1) * max(cur_maxlen, ln)
            over = ((budget is not None and cost > budget) or
                    (budget is None and nblk > self.max_blocks_per_chunk))
            if cur and over:
                yield self._execute(cur)
                cur, cur_blocks, cur_maxlen = [], set(), 0
            cur.append((s, ln))
            cur_blocks.update(pb)
            cur_maxlen = max(cur_maxlen, ln)
        if cur:
            yield self._execute(cur)

    def _execute(self, pieces) -> np.ndarray:
        bs = self.store.block_size
        starts = np.asarray([p[0] for p in pieces], np.int64)
        lengths = np.asarray([p[1] for p in pieces], np.int64)
        plan = self.planner.plan_spans(starts, lengths)
        # the block-selection decode stays exact-size (pad_groups=False
        # too): pow2-padding the unique rows could double resident bytes
        # and break the budget. The block cache is bypassed.
        uniq = plan.host_cover()[3]
        dec = self.store.decoder
        decode = (dec.decode_blocks if self.mode2
                  else dec.decode_blocks_host_entropy)
        rows = decode(uniq, verify=self.verify, pad_groups=False,
                      on_error=self.on_error)
        # one device-to-host copy of the chunk, cut into pieces on the host
        host = _gather_plan(rows, plan)[:plan.n_queries].cpu().numpy()
        parts = [host[i, :int(lengths[i])] for i in range(len(pieces))]
        # one piece (a whole-file scan) is its own row: no second copy
        payload = parts[0] if len(parts) == 1 else np.concatenate(parts)
        # decoded_blocks_last is what the decoder materialized: the unique
        # covering rows for "ra", the summed anchor windows for
        # checkpointed wavefronts, the whole prefix when anchor-free
        n_decoded = int(dec.decoded_blocks_last)
        self.chunk_log.append(ChunkStats(
            n_spans=len(pieces), n_blocks=n_decoded,
            decoded_bytes=n_decoded * bs,
            gather_bytes=plan.batch * plan.max_len,
            yielded_bytes=int(payload.size)))
        return payload


class ShardedExecutor:
    """A plan's decode fanned out over several cards: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise _not_in_slice("ShardedExecutor", "multi-GPU residency")
