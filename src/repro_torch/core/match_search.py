"""Host-side LZ77 match search (encode-once / decode-many, paper §8).

Vectorized numpy hash matcher + greedy token-level parse. Two windows:

  "ra"     — match sources constrained to the same block: every block is
             self-contained → position-invariant random access (paper §4).
  "global" — paper-1 wavefront style: sources anywhere earlier in the file,
             offsets stored absolute (the property that makes parallel and
             out-of-order decode possible at all).

The searcher is deliberately one-probe (LZ4-class): the paper positions
ACEAPEX on decode speed/seek at *comparable* ratio, not maximal ratio
(§6.2), and encode speed is an accepted limitation.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.format import MAX_LEN, MIN_MATCH

_HASH_MUL = np.uint32(2654435761)


ACCEPT_LEN = 8  # parse-level accept threshold (8-gram hash selectivity);
                # the format floor stays MIN_MATCH=4

def _gram_hash(data: np.ndarray, bits: int) -> np.ndarray:
    """8-gram hash for positions 0..n-8 (vectorized). 8 grams matter for
    genomic data: a 4-gram over {A,C,G,T} has only 256 states, so the
    one-probe table would be pure false sharing."""
    n = data.shape[0]
    if n < 8:
        return np.zeros(0, np.uint32)
    d = data.astype(np.uint64)
    g = np.zeros(n - 7, np.uint64)
    for b in range(8):
        g |= d[b:n - 7 + b] << np.uint64(8 * b)
    h = (g * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(64 - bits)
    return h.astype(np.uint32)


def _prev_same_hash(h: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """cand1[i]/cand2[i] = two largest j < i with h[j] == h[i], else -1."""
    n = h.shape[0]
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy()
    order = np.argsort(h, kind="stable")          # groups equal hashes, pos asc
    cand1 = np.full(n, -1, np.int64)
    cand2 = np.full(n, -1, np.int64)
    same = h[order[1:]] == h[order[:-1]]
    cand1[order[1:][same]] = order[:-1][same]
    same2 = same[1:] & same[:-1]
    cand2[order[2:][same2]] = order[:-2][same2]
    return cand1, cand2


def _match_lengths(data: np.ndarray, pos: np.ndarray, src: np.ndarray,
                   limit: np.ndarray) -> np.ndarray:
    """Vectorized longest-common-extension for (pos, src) pairs, word-at-a-time
    then byte fixup. `limit` caps each pair (block end / MAX_LEN)."""
    n = data.shape[0]
    # 8-byte word view (zero-padded tail)
    pad = (-n) % 8 + 8
    dp = np.concatenate([data, np.zeros(pad, np.uint8)])
    lens = np.zeros(pos.shape[0], np.int64)
    active = np.arange(pos.shape[0])
    # word-at-a-time phase
    while active.size:
        p = pos[active] + lens[active]
        s = src[active] + lens[active]
        room = limit[active] - lens[active]
        w_ok = room >= 8
        if w_ok.any():
            a = active[w_ok]
            pw = pos[a] + lens[a]
            sw = src[a] + lens[a]
            # unaligned 8-byte compare via view on byte pairs
            eq = np.ones(a.size, bool)
            for b in range(8):
                eq &= dp[pw + b] == dp[sw + b]
            lens[a[eq]] += 8
            # keep word-advancing only where a full word matched
            nxt = a[eq]
        else:
            nxt = np.zeros(0, np.int64)
        # byte fixup for pairs that can no longer take a full word
        done_word = np.setdiff1d(active, nxt, assume_unique=False)
        for _ in range(8):
            if not done_word.size:
                break
            p = pos[done_word] + lens[done_word]
            s = src[done_word] + lens[done_word]
            ok = (lens[done_word] < limit[done_word]) & (dp[p] == dp[s])
            lens[done_word[ok]] += 1
            done_word = done_word[ok]
        active = nxt
    return lens


def _run_lengths(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """RLE helper: for each position i, length of the run of equal bytes
    starting at i (forward run length). O(n) vectorized."""
    n = data.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    brk = np.empty(n, bool)
    brk[-1] = True
    brk[:-1] = data[1:] != data[:-1]
    idx = np.arange(n)
    last = idx[brk]
    next_break = last[np.searchsorted(last, idx)]
    fwd = next_break - idx + 1
    is_run = np.empty(n, bool)
    is_run[0] = False
    is_run[1:] = data[1:] == data[:-1]
    return fwd, is_run


def find_matches(data: np.ndarray, base: int = 0, hash_bits: int = 17,
                 global_cand: np.ndarray | None = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-position best candidate (absolute) and match length within `data`.

    Returns (cand_abs int64[n] (-1 = none), mlen int64[n]). `base` is the
    absolute output position of data[0] (for "ra" blocks: the block start).
    """
    n = data.shape[0]
    cand = np.full(n, -1, np.int64)
    mlen = np.zeros(n, np.int64)
    if n < MIN_MATCH:
        return cand, mlen

    h = _gram_hash(data, hash_bits)
    c, c2 = _prev_same_hash(h)

    # RLE fast path: runs match offset-1 with long lengths, and defeat the
    # one-probe hash on constant regions (pathological LCE cost otherwise).
    fwd, is_run = _run_lengths(data)
    run_pos = np.flatnonzero(is_run)
    cand[run_pos] = run_pos - 1
    mlen[run_pos] = np.minimum(fwd[run_pos], MAX_LEN)

    for probe in (c, c2):
        hp = np.flatnonzero(probe >= 0)
        hp = hp[~is_run[hp]]                   # runs already handled
        if not hp.size:
            continue
        src = probe[hp]
        # cap hash-match LCE: bounds pathological periodic inputs; runs
        # are already handled by the RLE fast path above
        limit = np.minimum(np.minimum(n - hp, MAX_LEN), 4096)
        lens = _match_lengths(data, hp, src, limit)
        better = lens > mlen[hp]
        cand[hp[better]] = src[better]
        mlen[hp[better]] = lens[better]

    ok = mlen >= ACCEPT_LEN
    cand = np.where(ok, cand, -1)
    mlen = np.where(ok, mlen, 0)
    cand = np.where(cand >= 0, cand + base, -1)
    return cand, mlen


def greedy_parse(n: int, cand: np.ndarray, mlen: np.ndarray
                 ) -> List[Tuple[int, int, int]]:
    """Greedy token parse → [(lit_len, match_len, src_abs)] covering n bytes.

    Token-level loop with vectorized skip-ahead to the next usable match, so
    the Python iteration count is O(#tokens), not O(n).
    """
    good = np.flatnonzero(mlen >= ACCEPT_LEN)
    tokens: List[Tuple[int, int, int]] = []
    pos = 0
    lit_start = 0
    while pos < n:
        gi = np.searchsorted(good, pos)
        if gi >= good.size:
            break
        p = int(good[gi])
        # one-step lazy match: defer if the next position matches longer
        if p + 1 < n and mlen[p + 1] > mlen[p] + 1:
            p = p + 1
        tokens.append((p - lit_start, int(mlen[p]), int(cand[p])))
        pos = p + int(mlen[p])
        lit_start = pos
    if lit_start < n:
        tokens.append((n - lit_start, 0, 0))
    return tokens
