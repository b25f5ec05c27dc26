"""The yardstick's peaks and the work each kernel's inputs need.

Peaks of one NVIDIA H100 SXM: HBM bytes/s from the data sheet, and the
issue rate of 32-bit integer instructions, 132 SMs x 4 schedulers x 32
lanes x 1.98 GHz boost clock. The counts are a frozen copy of
`chip_smoke.py::phase_timing`'s: each input byte read once, each output
byte written once, and the operations the algorithm needs, whatever the
kernel issues. They are computed per block of the tile, from the
archive's stream tables, and summed over the blocks a request decodes.
"""
from __future__ import annotations

import numpy as np

PEAK_BYTES = 3.35e12
PEAK_OPS = 132 * 4 * 32 * 1.98e9
RANS_OPS_PER_LANE_STEP = 10       # slot mask, table load, 2 field
                                  # extracts, shift, multiply-add, compare,
                                  # ballot, popc, store
LZ77_OPS_PER_BYTE = 2             # load the byte's source, store the byte
STREAMS = 4
PROB_SCALE = 4096                 # rANS slot table entries a stream
RANS_LAUNCH_BYTES = STREAMS * PROB_SCALE * 4   # slot tables, once a launch


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the chip could take: bytes or operations."""
    return max(n_bytes / PEAK_BYTES, n_ops / PEAK_OPS)


def stream_row_bytes(block_size: int, max_cmds: int,
                     offset_bytes: int) -> int:
    """Bytes of one block's decoded stream row: literals, lengths,
    offsets and commands, padded to 16."""
    row = block_size + 2 * max_cmds + offset_bytes * max_cmds + 2 * max_cmds
    return -(-row // 16) * 16


def block_work(lanes: np.ndarray, n_syms: np.ndarray, n_words: np.ndarray,
               n_cmds: np.ndarray, block_size: int,
               offset_bytes: int) -> dict:
    """Per-block work of the two kernels → {name: f64[n_blocks]}.

    `lanes`, `n_syms`, `n_words` are (n_blocks, 4) stream tables (stream
    0 the literals), `n_cmds` (n_blocks,). `compressed` is the block's
    stream words in bytes; `raw` the bytes it decodes to."""
    lanes = np.maximum(np.asarray(lanes, np.int64), 1)
    nsym = np.asarray(n_syms, np.int64)
    nwords = np.asarray(n_words, np.int64)
    ncmd = np.asarray(n_cmds, np.int64)
    max_cmds = int(ncmd.max(initial=1))
    widths = np.array([block_size, 2 * max_cmds, offset_bytes * max_cmds,
                       2 * max_cmds], np.int64)[None, :]
    n_out = np.minimum(nsym, widths)
    row = stream_row_bytes(block_size, max_cmds, offset_bytes)
    f = np.float64
    return {
        "rans_bytes": (2 * (2 * lanes + nwords).sum(1)      # stream words
                       + STREAMS * (8 + 4 + 4)              # stream table
                       + row).astype(f),                    # stream row
        "rans_ops": (RANS_OPS_PER_LANE_STEP
                     * (-(-n_out // lanes) * lanes).sum(1)).astype(f),
        "lz77_bytes": ((4 + offset_bytes) * ncmd             # command planes
                       + nsym[:, 0]                          # literals
                       + 2 * 4 + block_size).astype(f),      # table, output
        "lz77_ops": np.full(ncmd.shape, LZ77_OPS_PER_BYTE * block_size, f),
        "compressed": (2 * nwords.sum(1)).astype(f),
        "raw": np.full(ncmd.shape, float(block_size)),
    }


class RangeWork:
    """Work of decoding any block range of a tiled archive, from the
    per-block work of one tile."""

    def __init__(self, per_block: dict, tile_blocks: int):
        self.tile_blocks = tile_blocks
        self.total = {k: float(v.sum()) for k, v in per_block.items()}
        self.prefix = {k: np.concatenate([[0.0], np.cumsum(v)])
                       for k, v in per_block.items()}

    def _upto(self, key: str, b: int) -> float:
        full, part = divmod(int(b), self.tile_blocks)
        return full * self.total[key] + float(self.prefix[key][part])

    def of_range(self, b0: int, b1: int) -> dict:
        """{name: work} of blocks [b0, b1) decoded in one launch of each
        kernel (the rANS slot tables counted once)."""
        out = {k: self._upto(k, b1) - self._upto(k, b0) for k in self.total}
        out["rans_bytes"] += RANS_LAUNCH_BYTES
        return out
