"""XOR parity over compressed payload words (group-local RAID-5).

The parity unit is a block's payload word range
(`format.block_payload_bounds`): the contiguous slice of `Archive.words`
holding all four of its entropy streams — the same for both entropy
backends, which lay streams out block-major. Group g covers blocks
[g*k, (g+1)*k); its parity row is the XOR of the group's zero-padded
payloads, sized to the group's longest payload. Any SINGLE corrupted
payload in a group is then recoverable as

    payload[b] = parity[g] XOR (XOR of the group's other payloads)

and the reconstruction runs on the device over the resident words
buffer, patched in place: the compressed archive never round-trips to
the host to heal. Two corruptions in one group reconstruct to garbage,
which the mandatory re-verify catches (unrecoverable, never silent).

k = 1 degenerates to replication (each "group" is one block and its
parity row is a full copy); large k amortizes parity bytes at the cost
of tolerating fewer simultaneous failures.

The reference rebuilds with one jitted XOR gather that pads and copies
the whole words buffer; it has no Pallas kernel, so the port's rebuild
is plain PyTorch too: one XOR per sibling slice into the bad block's
parity row, then one copy into the words buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.format import Archive, block_payload_bounds


def build_parity(words: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                 parity_group: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side parity build (encode time): XOR the payload word ranges
    of every `parity_group`-block group into one parity row per group.
    Returns (parity_words u16 flat, parity_off i64[n_groups + 1])."""
    k = int(parity_group)
    if k <= 0:
        raise ValueError(f"parity_group must be positive, got {k}")
    n_blocks = int(np.asarray(starts).shape[0])
    lens = (np.asarray(ends, np.int64) - np.asarray(starts, np.int64))
    n_groups = -(-n_blocks // k) if n_blocks else 0
    rows = []
    off = [0]
    for g in range(n_groups):
        blks = range(g * k, min((g + 1) * k, n_blocks))
        width = int(max((int(lens[b]) for b in blks), default=0))
        row = np.zeros(width, np.uint16)
        for b in blks:
            pay = words[int(starts[b]):int(ends[b])]
            row[:pay.size] ^= pay
        rows.append(row)
        off.append(off[-1] + width)
    pw = (np.concatenate(rows).astype(np.uint16) if rows
          else np.zeros(0, np.uint16))
    return pw, np.asarray(off, np.int64)


def with_parity(a: Archive, parity_group: int) -> Archive:
    """`a` with the XOR-parity tail of `parity_group`-block groups: the
    archive `encode(..., parity_group=parity_group)` returns for the same
    data (the payload words are the same; only the tail is added)."""
    starts, ends = block_payload_bounds(a)
    pw, po = build_parity(a.words, starts, ends, parity_group)
    return dataclasses.replace(a, parity_group=int(parity_group),
                               parity_words=pw, parity_off=po)


def xor_rebuild(words: torch.Tensor, siblings: Sequence[Tuple[int, int]],
                parity_row: torch.Tensor, bad_start: int) -> torch.Tensor:
    """Fold the sibling payloads `(start, length)` of `words` (i16, the
    u16 buffer's bits) into `parity_row` — each sibling masked past its
    own length — and write the result over
    `words[bad_start:bad_start + len(parity_row)]` in place. Returns the
    rebuilt payload."""
    acc = parity_row.clone()
    n = acc.shape[0]
    for s, ln in siblings:
        m = min(int(ln), n)
        if m:
            acc[:m] ^= words[s:s + m]
    words[bad_start:bad_start + n] = acc
    return acc


def reconstruct_blocks(decoder, bad) -> np.ndarray:
    """Reconstruct the payloads of block ids `bad` from their parity
    groups on the decoder's device, patching BOTH the resident words
    buffer (`decoder.da.words`, in place: every decode reads that one
    tensor) and the host archive copy (Mode 1 decodes from it, and the
    two must stay equal for re-serialization). Returns the ids actually
    reconstructed — empty when the archive carries no parity.
    Reconstruction is NOT verification: callers must re-decode and
    re-verify the returned blocks (a corrupt sibling makes the rebuilt
    payload garbage, which only the digest check can tell)."""
    a = decoder.archive
    k = int(a.parity_group)
    bad = np.unique(np.asarray(bad, np.int64).reshape(-1))
    if k <= 0 or bad.size == 0:
        return np.zeros(0, np.int64)
    starts, ends = block_payload_bounds(a)
    lens = ends - starts
    poff = np.asarray(a.parity_off, np.int64)
    if int((poff[1:] - poff[:-1]).max(initial=0)) == 0:
        return bad          # every payload is empty: nothing to rebuild
    words = decoder.da.words
    pwords = np.asarray(a.parity_words, np.uint16).view(np.int16)
    for b in bad.tolist():
        g = b // k
        s, n = int(starts[b]), int(lens[b])
        sibs = [(int(starts[i]), int(lens[i]))
                for i in range(g * k, min((g + 1) * k, a.n_blocks))
                if i != b]
        lo = int(poff[g])
        # the group's parity row, cut to the bad payload's own length
        prow = torch.from_numpy(pwords[lo:lo + n].copy()).to(words.device)
        rebuilt = xor_rebuild(words, sibs, prow, s)
        a.words[s:s + n] = rebuilt.cpu().numpy().view(np.uint16)
    return bad
