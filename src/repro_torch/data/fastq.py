"""Synthetic FASTQ corpora.

The two regimes of the paper are parameterized synthetically:

  make_fastq("platinum")  — NA12878-like: PCR-free, low-entropy quality
                            strings, duplicated fragments → high LZ ratio
  make_fastq("noisy")     — ERR194147-like: noisy quality strings → 3–4×
"""
from __future__ import annotations

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
