"""ACEAPEX encoder (host, numpy, encode-once/decode-many).

Pipeline: partition output space into blocks → match search (per-block in
"ra" mode, global in "global"/wavefront mode) → greedy parse → four byte
streams per block → archive-global entropy tables → one batched rANS encode
over every stream of every block.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core import depth as dpth
from repro_torch.core import entropy as ent
from repro_torch.core import match_search as ms
from repro_torch.core.format import (DEFAULT_BLOCK_SIZE, MAX_LEN, N_STREAMS,
                               S_COMMANDS, S_LENGTHS, S_LITERALS, S_OFFSETS,
                               Archive, file_digest, fnv1a64_u64_stride)


def _planes_u16(vals: np.ndarray) -> np.ndarray:
    v = vals.astype(np.uint32)
    return np.concatenate([(v & 0xFF).astype(np.uint8),
                           (v >> 8).astype(np.uint8)])


def _planes_u32(vals: np.ndarray) -> np.ndarray:
    v = vals.astype(np.uint32)
    return np.concatenate([((v >> np.uint32(8 * b)) & np.uint32(0xFF))
                           .astype(np.uint8) for b in range(4)])


def _planes_u64(vals: np.ndarray) -> np.ndarray:
    v = vals.astype(np.uint64)
    return np.concatenate([((v >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint8)
                           for b in range(8)])


def validate_encode_params(block_size: int, mode: str, entropy: str,
                           anchor_interval: int, raw_size: int = 0,
                           origin: int = 0, parity_group: int = 0) -> None:
    """Raise ValueError on any invalid encode-knob combination.

    The single home of the knob constraints (an encode-knob sweep rejects
    a grid point up front with a reason instead of raising mid-sweep)."""
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    if mode not in ("ra", "global"):
        raise ValueError(f'mode must be "ra" or "global", got {mode!r}')
    if entropy not in ("rans", "raw"):
        raise ValueError(f"unknown entropy backend {entropy!r}")
    if anchor_interval < 0:
        raise ValueError(
            f"anchor_interval must be >= 0, got {anchor_interval}")
    if anchor_interval and mode != "global":
        raise ValueError(
            'anchor_interval only applies to mode="global" ("ra" blocks '
            "are already self-contained restart points)")
    if origin < 0:
        raise ValueError(f"origin must be >= 0, got {origin}")
    if parity_group < 0:
        raise ValueError(
            f"parity_group must be >= 0 (0 = no parity), got {parity_group}")
    if mode == "global":
        # the device match phase resolves a decode window in one flat
        # int32 pointer space, so a single window must span < 2^31 bytes;
        # anchor-free archives decode whole-prefix (one raw_size window)
        if not anchor_interval and raw_size >= 2**31:
            raise ValueError(
                f"anchor-free global archives decode as ONE {raw_size}-byte "
                f"window, past the device's 2 GiB flat pointer space — "
                f"encode with anchor_interval to bound windows")
        if anchor_interval and anchor_interval * block_size >= 2**31:
            raise ValueError(
                f"anchor window spans {anchor_interval} x {block_size} "
                f">= 2 GiB — the device flat pointer space is int32; "
                f"use a smaller anchor_interval")


def encode(data: bytes | np.ndarray,
           block_size: int = DEFAULT_BLOCK_SIZE,
           mode: str = "ra",
           entropy: str = "rans",
           hash_bits: int = 17,
           anchor_interval: int = 0,
           origin: int = 0,
           parity_group: int = 0) -> Archive:
    """Compress `data` into an ACEAPEX archive.

    `anchor_interval` (global mode only) emits a wavefront restart point
    every that many blocks: the match window resets at each anchor, so
    every match in blocks [anchor, next_anchor) sources only bytes at or
    after the anchor's start. Any block then decodes from its governing
    anchor instead of the whole prefix (bounded random access), at the
    cost of matches that can no longer cross anchor boundaries.
    0 keeps the anchor-free whole-file window.

    `origin` places the archive at an absolute byte offset of a larger
    logical file (multi-shard archives): block starts and global-mode
    match offsets are recorded relative to that origin. Block-level decode
    APIs are origin-transparent; byte-addressed query-plane entry points
    assume origin == 0.

    `parity_group=k` (k > 0) XORs the compressed payload words of every
    k-block group into a parity row stored in the v4 format tail: any
    single corrupted block of a group is reconstructable on the device
    (`repro_torch.resilience`). k=1 is payload replication; parity
    overhead is roughly 1/k of the payload bytes. 0 (default) writes a
    parity-free archive, byte-identical to the v3 format.
    """
    data = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.ascontiguousarray(data, np.uint8)
    n = data.shape[0]
    anchor_interval = int(anchor_interval)
    origin = int(origin)
    parity_group = int(parity_group)
    validate_encode_params(block_size, mode, entropy, anchor_interval,
                           raw_size=n, origin=origin,
                           parity_group=parity_group)
    # "ra" offsets are block-local; two planes hold them only while the
    # block fits 16 bits. Larger blocks (e.g. PAPER1_BLOCK_SIZE) switch to
    # four planes — storing a >=64 KiB offset in two would silently
    # truncate it and corrupt every match past the 16-bit horizon.
    if mode == "ra":
        offset_bytes = 2 if block_size <= 0xFFFF else 4
        _ra_planes = _planes_u16 if offset_bytes == 2 else _planes_u32
    else:
        offset_bytes = 8
    n_blocks = max(1, -(-n // block_size))
    block_start = origin + (np.arange(n_blocks, dtype=np.int64) * block_size)
    block_len = np.minimum(n - (block_start - origin),
                           block_size).astype(np.int32)
    block_len = np.maximum(block_len, 0)

    anchors = np.zeros(0, np.int64)
    if mode == "global":
        if anchor_interval:
            anchors = np.arange(0, n_blocks, anchor_interval, dtype=np.int64)
        if anchors.size:
            # checkpointed wavefront: one independent match search per
            # anchor window — candidates cannot reference bytes before
            # their window's anchor, so [anchor, last] decodes alone
            g_cand = np.full(n, -1, np.int64)
            g_mlen = np.zeros(n, np.int64)
            bounds = np.append(anchors, n_blocks) * block_size
            for ws, we in zip(bounds[:-1], np.minimum(bounds[1:], n)):
                ws, we = int(ws), int(we)
                c, m = ms.find_matches(data[ws:we], base=origin + ws,
                                       hash_bits=hash_bits)
                g_cand[ws:we] = c
                g_mlen[ws:we] = m
        else:
            g_cand, g_mlen = ms.find_matches(data, base=origin,
                                             hash_bits=hash_bits)

    streams: List[np.ndarray] = []
    class_ids: List[int] = []
    n_cmds = np.zeros(n_blocks, np.int32)
    block_fnv = np.zeros(n_blocks, np.uint64)
    block_depth = np.zeros(n_blocks, np.int32)
    if mode == "global":
        # wavefront chains cross blocks, so depth is measured per anchor
        # window; blocks arrive in order, so one window's pointer arrays
        # (i32, window-relative — windows are guarded < 2^31 bytes) are
        # buffered and freed at the window edge. Peak host memory is a
        # few bytes per byte of ONE window; anchor-free archives have one
        # whole-file window by construction, which the < 2 GiB encode
        # guard above already bounds.
        win_of = (np.searchsorted(anchors, np.arange(n_blocks), "right") - 1
                  if anchors.size else np.zeros(n_blocks, np.int64))
    win_ptrs: List[np.ndarray] = []
    win_first = 0

    for b in range(n_blocks):
        s, ln = int(block_start[b]) - origin, int(block_len[b])
        blk = data[s:s + ln]
        block_fnv[b] = np.uint64(fnv1a64_u64_stride(blk))
        if mode == "ra":
            cand, mlen = ms.find_matches(blk, base=0, hash_bits=hash_bits)
            tokens = ms.greedy_parse(ln, cand, mlen)
        else:
            # global candidates; cap match dest inside this block
            c = g_cand[s:s + ln].copy()
            m = g_mlen[s:s + ln].copy()
            m = np.minimum(m, ln - np.arange(ln))
            m = np.where(m >= ms.MIN_MATCH, m, 0)
            tokens = [(ll, ml, src) for (ll, ml, src)
                      in ms.greedy_parse(ln, np.where(m > 0, c, -1), m)]

        lit_lens: List[int] = []
        mlens: List[int] = []
        offs: List[int] = []
        lit_chunks: List[np.ndarray] = []
        cur = 0
        for (ll, ml, src) in tokens:
            if ll:
                lit_chunks.append(blk[cur:cur + ll])
            cur += ll + ml
            while ll > MAX_LEN:
                lit_lens.append(MAX_LEN)
                mlens.append(0)
                offs.append(0)
                ll -= MAX_LEN
            lit_lens.append(ll)
            mlens.append(ml)
            if ml:
                # "ra": src is already block-local (find_matches base=0);
                # "global": src is absolute
                offs.append(src)
            else:
                offs.append(0)
        assert cur == ln, f"parse covered {cur} of {ln}"
        n_cmds[b] = len(lit_lens)

        literals = (np.concatenate(lit_chunks) if lit_chunks
                    else np.zeros(0, np.uint8))
        ll_a = np.asarray(lit_lens, np.uint32)
        ml_a = np.asarray(mlens, np.uint32)
        of_a = np.asarray(offs, np.uint64)
        # measure the block's exact pointer-resolution depth: the decoder
        # will run exactly this many doubling rounds instead of
        # ceil(log2(block_size)). "ra" blocks resolve alone; global-mode
        # chains cross blocks, so pointers buffer per anchor window
        # (rebased to window coordinates — the host twin of the decode's
        # flat pointer space) and resolve at the window edge.
        if mode == "ra":
            block_depth[b] = dpth.block_depth_ra(ll_a, ml_a, of_a, ln)
        else:
            if not win_ptrs:
                win_first = b
            ws = int(block_start[win_first])
            ptr = dpth.expand_pointers_np(ll_a, ml_a, of_a.astype(np.int64),
                                          ln, base=int(block_start[b]))
            win_ptrs.append(np.where(ptr < 0, ptr, ptr - ws)
                            .astype(np.int32))
            if b + 1 == n_blocks or win_of[b + 1] != win_of[b]:
                blks = np.arange(win_first, b + 1)
                block_depth[blks] = dpth.window_depths(win_ptrs,
                                                       block_len[blks])
                win_ptrs = []
        streams.append(literals)
        class_ids.append(S_LITERALS)
        streams.append(_planes_u16(ml_a))
        class_ids.append(S_LENGTHS)
        streams.append(_ra_planes(of_a) if mode == "ra" else _planes_u64(of_a))
        class_ids.append(S_OFFSETS)
        streams.append(_planes_u16(ll_a))
        class_ids.append(S_COMMANDS)

    # archive-global entropy tables, one per stream class
    hists = np.zeros((N_STREAMS, 256), np.int64)
    for st, c in zip(streams, class_ids):
        if st.size:
            hists[c] += np.bincount(st, minlength=256)
    freqs = np.stack([ent.normalize_freqs(hists[c]) for c in range(N_STREAMS)])

    if entropy == "rans":
        words, w_off, n_words, n_syms, lanes = ent.rans_encode_batch(
            streams, class_ids, freqs)
    elif entropy == "raw":
        # uncompressed byte-pack fallback (2 bytes/word) — the "other entropy
        # backend" used by the §6.4-style backend comparison
        sizes = np.array([st.size for st in streams], np.int64)
        n_words = (-(-sizes // 2)).astype(np.int32)
        w_off = np.concatenate([[0], np.cumsum(n_words[:-1])]).astype(np.int64)
        words = np.zeros(int(n_words.sum()), np.uint16)
        for i, st in enumerate(streams):
            p = st if st.size % 2 == 0 else np.concatenate(
                [st, np.zeros(1, np.uint8)])
            words[w_off[i]:w_off[i] + n_words[i]] = (
                p[0::2].astype(np.uint16) | (p[1::2].astype(np.uint16) << 8))
        n_syms = sizes.astype(np.int32)
        lanes = np.ones(len(streams), np.int32)
    else:
        raise ValueError(f"unknown entropy backend {entropy!r}")

    S = len(streams)
    assert S == N_STREAMS * n_blocks
    a = Archive(
        block_size=block_size,
        raw_size=n,
        mode=mode,
        entropy=entropy,
        freqs=freqs,
        words=words,
        word_off=np.asarray(w_off, np.int64).reshape(n_blocks, N_STREAMS),
        n_words=np.asarray(n_words, np.int32).reshape(n_blocks, N_STREAMS),
        n_syms=np.asarray(n_syms, np.int32).reshape(n_blocks, N_STREAMS),
        lanes=np.asarray(lanes, np.int32).reshape(n_blocks, N_STREAMS),
        n_cmds=n_cmds,
        block_start=block_start,
        block_len=block_len,
        block_fnv=block_fnv,
        file_fnv=file_digest(block_fnv),
        offset_bytes=offset_bytes,
        anchor_interval=anchor_interval if anchors.size else 0,
        anchors=anchors,
        block_depth=block_depth,
    )
    if parity_group:
        # block b's payload = words[word_off[b,0] : word_off[b+1,0]) — the
        # four streams lie consecutively, both entropy backends
        from repro_torch.resilience.parity import with_parity
        a = with_parity(a, parity_group)
    return a
