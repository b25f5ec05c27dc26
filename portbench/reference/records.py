"""Plain NumPy reference of what the store must return.

The resident archive is the tile repeated `tiles` times end to end, so
raw block `b` of the archive is block `b mod tile_blocks` of the tile.
This module answers block ranges from the tile's bytes alone: it
imports nothing of the program and takes nothing the program made.
"""
from __future__ import annotations

import numpy as np


class Reference:
    """Expected bytes of block ranges of the tiled archive."""

    def __init__(self, tile: bytes, block_size: int, tiles: int):
        self.tile = np.frombuffer(tile, np.uint8)
        if self.tile.size % block_size:
            raise ValueError("the tile is not block-aligned")
        self.block_size = block_size
        self.tiles = tiles
        self.tile_blocks = self.tile.size // block_size
        self.n_blocks = self.tile_blocks * tiles

    def block_rows(self, b0: int, b1: int) -> np.ndarray:
        """(b1 - b0, block_size) u8: raw blocks [b0, b1) of the archive."""
        rows = self.tile.reshape(self.tile_blocks, self.block_size)
        return rows[np.arange(b0, b1, dtype=np.int64) % self.tile_blocks]
