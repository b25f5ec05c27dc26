"""Byte-level tokenizer for the LM training pipeline.

The compressed-resident corpus stores raw bytes; a sequence record is
`seq_len` bytes → `seq_len` token ids (0..255 + specials). Vocab-sized
models simply embed ids modulo their vocab (configs all have vocab ≥ 256,
so byte ids embed losslessly)."""
from __future__ import annotations

import numpy as np

PAD_ID = 0
VOCAB_BYTES = 256


def encode_bytes(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8).astype(np.int32)


def decode_bytes(tokens: np.ndarray) -> bytes:
    return np.asarray(tokens, np.uint8).tobytes()
