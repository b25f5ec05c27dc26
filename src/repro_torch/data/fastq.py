"""Synthetic FASTQ corpora.

The two regimes of the paper are parameterized synthetically:

  make_fastq("platinum")  — NA12878-like: PCR-free, low-entropy quality
                            strings, duplicated fragments → high LZ ratio
  make_fastq("noisy")     — ERR194147-like: noisy quality strings → 3–4×

Also stream separation (ids/sequences/qualities stored apart, the
universal +10–11 % of the paper's §6.2) and the byte-altering transforms
(2-bit packing, quality delta, transpose) the paper shows HURT an LZ77
codec, in numpy as the reference has them.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", np.uint8)


def make_fastq(kind: str = "platinum", n_reads: int = 2000, read_len: int = 100,
               seed: int = 0) -> bytes:
    """Synthetic Illumina-style FASTQ."""
    rng = np.random.default_rng(seed)
    # genome fragment pool: reads re-sample fragments (PCR duplicates /
    # high-coverage overlap) → LZ-compressible at the match layer
    n_frags = max(4, n_reads // (120 if kind == "platinum" else 30))
    frags = rng.choice(_BASES, size=(n_frags, read_len))
    recs = []
    if kind == "platinum":
        q_alpha = np.frombuffer(b"F:,", np.uint8)
        q_p = [0.97, 0.02, 0.01]
        mut = 0.0005
    elif kind == "noisy":
        q_alpha = np.frombuffer(b"FGHIJKLMNO@ABCDE", np.uint8)
        q_p = None  # uniform-ish
        mut = 0.02
    else:
        raise ValueError(kind)
    for i in range(n_reads):
        seq = frags[rng.integers(n_frags)].copy()
        flips = rng.random(read_len) < mut
        seq[flips] = rng.choice(_BASES, size=int(flips.sum()))
        if q_p is not None:
            qual = rng.choice(q_alpha, size=read_len, p=q_p)
        else:
            qual = rng.choice(q_alpha, size=read_len)
        recs.append(b"@SRR0.%d %d/1\n" % (i, i) + seq.tobytes() + b"\n+\n"
                    + qual.tobytes() + b"\n")
    return b"".join(recs)


def separate_streams(data: bytes) -> Tuple[bytes, bytes, bytes]:
    """(ids, sequences, qualities) — homogeneous grouping, §6.2."""
    ids, seqs, quals = [], [], []
    lines = data.split(b"\n")
    for i in range(0, len(lines) - 1, 4):
        ids.append(lines[i])
        seqs.append(lines[i + 1])
        quals.append(lines[i + 3])
    return (b"\n".join(ids) + b"\n", b"\n".join(seqs) + b"\n",
            b"\n".join(quals) + b"\n")


# ------------------------------- byte-altering transforms (they hurt, §6.2)
def pack_2bit(seq_stream: bytes) -> bytes:
    """2-bit base packing (destroys byte-aligned match repeats)."""
    arr = np.frombuffer(seq_stream, np.uint8)
    code = np.zeros(arr.shape, np.uint8)
    for v, b in enumerate(b"ACGT"):
        code[arr == b] = v
    pad = (-code.size) % 4
    code = np.concatenate([code, np.zeros(pad, np.uint8)])
    c = code.reshape(-1, 4)
    return (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4)
            | (c[:, 3] << 6)).astype(np.uint8).tobytes()


def quality_delta(qual_stream: bytes) -> bytes:
    arr = np.frombuffer(qual_stream, np.uint8).astype(np.int16)
    d = np.diff(arr, prepend=arr[:1])
    return (d & 0xFF).astype(np.uint8).tobytes()


def transpose_records(stream: bytes, record_len: int) -> bytes:
    arr = np.frombuffer(stream, np.uint8)
    n = (arr.size // record_len) * record_len
    return (arr[:n].reshape(-1, record_len).T.copy().tobytes()
            + arr[n:].tobytes())
