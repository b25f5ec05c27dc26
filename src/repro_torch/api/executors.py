"""Plan executor: how a DecodePlan becomes bytes on the device.

DeviceExecutor — entropy decode → match resolve → ragged gather, fully on
                 the device (`_fetch_dev_core` underneath). Whole-record
                 plans resolve their covering set from the device start
                 table (`_fetch_reads_core`); verified runs and plans whose
                 covering set avoids the archive's deepest depth bucket
                 take the staged variant: host covering set from the plan,
                 one decode launch per depth bucket, the same gather.

The streaming and sharded executors come with later slices of the port.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.api.plan import DecodePlan
from repro_torch.core.decoder import _not_in_slice, _pad_pow2, check_on_error
from repro_torch.core.residency import (_fetch_dev_core, _fetch_reads_core,
                                        _gather_reads_core)


class _DecoderStore:
    """Minimal store adapter so a bare `Decoder` rides the query plane
    (no index) without duplicating its device archive."""

    index = None
    _starts64 = None
    verify = False
    on_error = "raise"

    def __init__(self, decoder):
        self.decoder = decoder
        self.block_size = decoder.da.block_size


def _dev(x: np.ndarray, device, dtype=np.int64) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)


class DeviceExecutor:
    """Execute a DecodePlan on the store's device pipeline.

    Returns ((n_queries, max_len) u8 zero-padded rows, (n_queries,) i32
    lengths), both on the device.
    """

    def __init__(self, store):
        self.store = store

    def run(self, plan: DecodePlan, mode2: bool = True,
            verify: Optional[bool] = None, on_error: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        if not mode2:
            raise _not_in_slice("Mode 1 (host-entropy) decode", "Mode 1")
        store = self.store
        verify = store.verify if verify is None else verify
        check_on_error(store.on_error if on_error is None else on_error)
        dec = store.decoder
        dev = dec.device
        B = plan.n_queries
        if B == 0:
            return (torch.zeros((0, plan.max_len), dtype=torch.uint8,
                                device=dev),
                    torch.zeros((0,), dtype=torch.int32, device=dev))
        # verified runs are staged: the fused core has no digest check
        fused = not verify
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
        # staged: host covering set (pow2-padded as the reference pads
        # it, so `decoded_blocks_last` agrees), one decode launch per depth
        # bucket, then the same ragged gather; bytes stay on the device
        _, r0, _, uniq, row_map = plan.host_cover()
        rows = dec.decode_blocks(_pad_pow2(uniq), verify=verify)[:uniq.size]
        out = _gather_reads_core(rows, _dev(row_map, dev), _dev(r0, dev),
                                 _dev(plan.lengths, dev),
                                 block_size=plan.block_size,
                                 max_len=plan.max_len)
        return out[:B], lens
