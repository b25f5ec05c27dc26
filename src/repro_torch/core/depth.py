"""Encode-time chain-depth measurement (host twin of the decode resolver).

The decoder resolves cross-command match dependencies by pointer doubling:
each round replaces every unresolved pointer with its target's target, so
a chain needing D hops to reach a literal resolves in ⌈log2(D)⌉ rounds.
Historically the decoder ran the worst case — ⌈log2(block_size)⌉ rounds,
20 full-array gathers at the paper-1 1 MiB block — but with absolute
(ACEAPEX-style) offsets the real chain depth is a property of the *parse*,
fixed at encode time and typically a small constant. This module measures
it exactly: build the same per-byte pointer array the decoder expands
(`expand_pointers_np`, the numpy twin of `kernels.ref.expand_pointers`)
and run the same doubling recurrence to its fixpoint, recording the round
at which every byte resolves (`chain_depths_np`). The per-block maxima are
recorded in the archive (`Archive.block_depth`, v3 `ACEJAX04` header) so
every decode launch runs exactly `max_depth` rounds.

Like the index-point metadata that makes parallel gzip decode tractable
(Kerbiriou & Chikhi 2019), a few bytes of encode-time metadata delete the
majority of decode-side work.
"""
from __future__ import annotations

import numpy as np


def expand_pointers_np(lit_lens: np.ndarray, match_lens: np.ndarray,
                       offsets: np.ndarray, block_len: int,
                       base: int = 0) -> np.ndarray:
    """Per-output-byte source pointers for ONE block, on host.

    Exact numpy twin of `kernels.ref.expand_pointers` minus the padding
    slots (host arrays are exact-size): i64[block_len] where ptr >= 0 is a
    copy-from position in `base + local` coordinates and ptr < 0 encodes
    literal index -(ptr + 1). `offsets` are block-local when base == 0
    ("ra") or absolute ("global"/wavefront).
    """
    ll = np.asarray(lit_lens, np.int64)
    ml = np.asarray(match_lens, np.int64)
    off = np.asarray(offsets, np.int64)
    tot = ll + ml
    cum_tot = np.cumsum(tot)
    P = cum_tot - tot                              # command start positions
    cum_lit = np.cumsum(ll) - ll                   # literal base per command
    assert (int(cum_tot[-1]) if tot.size else 0) == block_len

    cmd_of = np.repeat(np.arange(tot.size, dtype=np.int64), tot)
    i = np.arange(block_len, dtype=np.int64)
    rel = i - P[cmd_of]
    is_lit = rel < ll[cmd_of]
    lit_idx = cum_lit[cmd_of] + rel
    # match source with self-overlap folding (dest start in `base` coords)
    mstart = base + P[cmd_of] + ll[cmd_of]
    d = np.maximum(mstart - off[cmd_of], 1)        # distance >= 1
    k = rel - ll[cmd_of]
    return np.where(is_lit, -(lit_idx + 1), off[cmd_of] + np.remainder(k, d))


def chain_depths_np(ptr: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """Pointer-doubling fixpoint: per-segment resolve-round counts.

    `ptr` is one flat pointer space (a single "ra" block, or a whole
    wavefront window rebased to window coordinates); `bounds` are the
    i64[n_segments + 1] segment edges (block starts within the flat
    space). Runs the decoder's exact doubling recurrence until every
    pointer is a literal and returns, per segment, the first round after
    which all of its bytes were resolved — 0 for all-literal segments.

    CONSUMES `ptr` (iterates without copying; the caller must not reuse
    it) — for an anchor-free global archive the flat space is the whole
    file, so the working set is kept to ptr + an i16 round map + one
    transient per round, not three full i64 twins.
    """
    p = np.asarray(ptr)
    bounds = np.asarray(bounds, np.int64)
    res_round = np.zeros(p.size, np.int16)   # rounds <= log2(2^31) = 31
    r = 0
    while (p >= 0).any():
        r += 1
        nxt = p[np.clip(p, 0, p.size - 1)]
        q = np.where(p >= 0, nxt, p)
        res_round[(p >= 0) & (q < 0)] = r
        if np.array_equal(q, p):       # defensive: malformed cycle
            break
        p = q
    n_seg = bounds.size - 1
    out = np.zeros(n_seg, np.int32)
    for s in range(n_seg):
        seg = res_round[bounds[s]:bounds[s + 1]]
        out[s] = int(seg.max(initial=0))
    return out


def block_depth_ra(lit_lens: np.ndarray, match_lens: np.ndarray,
                   offsets: np.ndarray, block_len: int) -> int:
    """Resolve-round count of one self-contained ("ra") block."""
    if block_len == 0:
        return 0
    ptr = expand_pointers_np(lit_lens, match_lens, offsets, block_len)
    # block-local pointers always fit i32 (blocks span < 2^31 bytes)
    return int(chain_depths_np(ptr.astype(np.int32),
                               np.array([0, block_len]))[0])


def window_depths(block_ptrs: list, block_lens: np.ndarray,
                  ) -> np.ndarray:
    """Per-block depths of one wavefront window.

    `block_ptrs` are the blocks' pointer arrays already rebased to window
    coordinates (match pointers relative to the window's first byte,
    literals negative); concatenated they form the window's flat pointer
    space — chains may cross blocks, exactly as the global decode resolves
    them. CONSUMES the list (cleared after concatenation) so the
    per-block buffers free as soon as the flat copy exists.
    """
    lens = np.asarray(block_lens, np.int64)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    if bounds[-1] == 0:
        block_ptrs.clear()
        return np.zeros(lens.size, np.int32)
    flat = (np.concatenate(block_ptrs) if block_ptrs
            else np.zeros(0, np.int32))
    block_ptrs.clear()
    return chain_depths_np(flat, bounds)


def log2_rounds(out_size: int) -> int:
    """The depth-free worst case the resolver historically ran."""
    return max(1, int(np.ceil(np.log2(max(out_size, 2)))))


# ------------------------------------------------------------ depth buckets
def depth_bucket(depth) -> np.ndarray:
    """Pow2 depth-bucket id: 0 → {0}, 1 → {1}, 2 → {2}, 3 → {3, 4},
    4 → {5..8}, 5 → {9..16}, ... — bucket b holds depths in
    (2^(b-2), 2^(b-1)] for b >= 2.

    Bucketing bounds the number of distinct `n_rounds` values a decode
    schedule can produce to ~log2(max_depth) + 2 per archive, which is
    what keeps the per-bucket launches from retracing the jitted decode
    once per distinct depth."""
    d = np.asarray(depth, np.int64)
    out = np.where(d <= 0, 0,
                   np.ceil(np.log2(np.maximum(d, 1))).astype(np.int64) + 1)
    return out if out.shape else out[()]


def scheduled_rounds(block_depth: np.ndarray) -> np.ndarray:
    """Per-block resolve-round schedule: each block runs the MAX depth of
    its archive-wide pow2 bucket (i32, same shape as `block_depth`).

    The schedule is archive-static — every selection of the same blocks
    runs the same per-bucket round counts — so the jitted decode sees at
    most one trace per (bucket, selection-shape) pair, and the tightness
    invariant holds: some block in each bucket needs exactly the bucket's
    scheduled count, so `scheduled - 1` rounds corrupts."""
    d = np.asarray(block_depth, np.int64).reshape(-1)
    if d.size == 0:
        return np.zeros(0, np.int32)
    b = depth_bucket(d)
    sched = np.zeros(int(b.max(initial=0)) + 1, np.int64)
    np.maximum.at(sched, b, d)
    return sched[b].astype(np.int32)


def bucket_histogram(rounds: np.ndarray) -> dict:
    """{scheduled_rounds: block_count} over a per-block schedule — the
    compact derived-field form the bench rows and `bench_compare` print."""
    r = np.asarray(rounds, np.int64).reshape(-1)
    vals, counts = np.unique(r, return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}
