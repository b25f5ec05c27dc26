"""Lane-interleaved rANS entropy stage (the open "DietGPU-route" backend).

Warp-interleaved ANS: K lanes decode in lockstep; the encoder (host,
numpy, encode-once) emits renormalization words in the exact reverse of
decode consumption order, so the decoder needs only a single shared word
cursor per stream — per-lane read offsets fall out of a lane-axis prefix
sum of the renorm mask (on the GPU, `__popc` of a warp ballot).

  state: uint32 in [2^16, 2^32) · 16-bit renorm words · 12-bit probabilities
  stream region layout: [2·K initial-state words][data words]

Encode is batched across *all* streams of an archive at once: one Python loop
over T_max steps, each step a vector op over (n_streams, K_max) — this is what
makes multi-MB host encode tractable without leaving numpy.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.format import (MAX_LANES, PROB_BITS, PROB_SCALE, RANS_L,
                               lanes_for)

_MASK = PROB_SCALE - 1


# ------------------------------------------------------------------ tables
def normalize_freqs(hist: np.ndarray, scale: int = PROB_SCALE) -> np.ndarray:
    """Normalize a 256-bin histogram to sum `scale`, every present symbol ≥ 1."""
    hist = np.asarray(hist, dtype=np.float64)
    total = hist.sum()
    if total == 0:
        # degenerate empty stream class: put all mass on symbol 0
        out = np.zeros(256, np.uint16)
        out[0] = scale
        return out
    f = hist * (scale / total)
    fi = np.floor(f).astype(np.int64)
    fi[(hist > 0) & (fi == 0)] = 1
    diff = scale - fi.sum()
    # distribute the remainder onto the largest bins (steal from them if < 0)
    order = np.argsort(-hist, kind="stable")
    i = 0
    step = 1 if diff > 0 else -1
    while diff != 0:
        j = order[i % 256]
        if hist[j] > 0 and (step > 0 or fi[j] > 1):
            fi[j] += step
            diff -= step
        i += 1
    assert fi.sum() == scale and np.all(fi[hist > 0] >= 1)
    return fi.astype(np.uint16)


def build_tables(freqs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """freqs (C, 256) -> (cum (C, 256) exclusive, sym_of_slot (C, PROB_SCALE))."""
    freqs = np.asarray(freqs, dtype=np.uint32)
    cum = np.cumsum(freqs, axis=1, dtype=np.uint32) - freqs
    sym = np.zeros((freqs.shape[0], PROB_SCALE), np.int32)
    for c in range(freqs.shape[0]):
        sym[c] = np.repeat(np.arange(256, dtype=np.int32), freqs[c])
    return cum, sym


# ------------------------------------------------------------------ encode
def rans_encode_batch(
    streams: Sequence[np.ndarray],
    class_ids: Sequence[int],
    freqs: np.ndarray,
    k_max: int = MAX_LANES,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Encode many byte streams at once.

    Returns (words, word_off, n_words, n_syms, lanes) where each stream's
    region in `words` is [2·K state words][n_words data words].
    """
    S = len(streams)
    freqs = np.asarray(freqs, np.uint32)
    cum, _ = build_tables(freqs)
    cls = np.asarray(class_ids, np.int32)

    n_syms = np.array([len(s) for s in streams], np.int32)
    K = np.array([lanes_for(int(n), k_max) for n in n_syms], np.int32)
    T = np.where(n_syms > 0, -(-n_syms // np.maximum(K, 1)), 0).astype(np.int32)
    T_max = int(T.max(initial=0))

    # (S, T_max, k_max) symbol tensor; symbol i of stream s sits at
    # (i // K_s, i % K_s). Pad tail with each stream's most frequent symbol.
    sym = np.zeros((S, max(T_max, 1), k_max), np.uint8)
    mf = np.argmax(freqs[cls], axis=1).astype(np.uint8)  # most frequent / class
    for s in range(S):
        k, t, n = int(K[s]), int(T[s]), int(n_syms[s])
        if n == 0:
            continue
        buf = np.full(t * k, mf[s], np.uint8)
        buf[:n] = streams[s]
        sym[s, :t, :k] = buf.reshape(t, k)

    lane_ok = np.arange(k_max)[None, :] < K[:, None]          # (S, K)
    states = np.full((S, k_max), RANS_L, np.uint32)

    emit_sid: List[np.ndarray] = []
    emit_word: List[np.ndarray] = []
    for t in range(T_max - 1, -1, -1):
        active = lane_ok & (t < T)[:, None]
        if not active.any():
            continue
        s_t = sym[:, t, :]
        F = freqs[cls[:, None], s_t]                           # (S, K) u32
        C = cum[cls[:, None], s_t]
        x_max = F.astype(np.uint64) << np.uint64(20)
        emit = active & (states.astype(np.uint64) >= x_max)
        if emit.any():
            # within-step order must be lane-DESCENDING (reverse of decode)
            emit_r = emit[:, ::-1]
            st_r = states[:, ::-1]
            sid, lidx = np.nonzero(emit_r)
            emit_sid.append(sid.astype(np.int32))
            emit_word.append((st_r[sid, lidx] & 0xFFFF).astype(np.uint16))
            states = np.where(emit, states >> 16, states)
        Fs = np.maximum(F, 1)
        q = states // Fs
        r = states - q * Fs
        new = ((q.astype(np.uint64) << np.uint64(PROB_BITS)) + r + C).astype(np.uint32)
        states = np.where(active, new, states)

    if emit_sid:
        E_sid = np.concatenate(emit_sid)
        E_word = np.concatenate(emit_word)
    else:
        E_sid = np.zeros(0, np.int32)
        E_word = np.zeros(0, np.uint16)

    # per-stream: reverse chronological emission order -> decode read order
    order = np.lexsort((-np.arange(E_sid.size), E_sid))
    E_sid_s = E_sid[order]
    E_word_s = E_word[order]
    n_data_words = np.bincount(E_sid_s, minlength=S).astype(np.int32)

    # assemble: [2K state words][data words] per stream
    total = int((2 * K).sum() + n_data_words.sum())
    words = np.zeros(total, np.uint16)
    word_off = np.zeros(S, np.int64)
    pos = 0
    dcur = np.concatenate([[0], np.cumsum(n_data_words)])
    for s in range(S):
        k = int(K[s])
        word_off[s] = pos
        st = states[s, :k]
        words[pos:pos + 2 * k:2] = (st & 0xFFFF).astype(np.uint16)
        words[pos + 1:pos + 2 * k:2] = (st >> 16).astype(np.uint16)
        pos += 2 * k
        nd = int(n_data_words[s])
        words[pos:pos + nd] = E_word_s[dcur[s]:dcur[s] + nd]
        pos += nd
    assert pos == total
    return words, word_off, n_data_words, n_syms, K


# ------------------------------------------------------- decode (numpy oracle)
def rans_decode_batch_np(
    words: np.ndarray,
    word_off: np.ndarray,
    n_syms: np.ndarray,
    lanes: np.ndarray,
    class_ids: np.ndarray,
    freqs: np.ndarray,
    k_max: int = MAX_LANES,
) -> List[np.ndarray]:
    """Pure-numpy batched decoder — the host oracle the device paths are
    verified against. Mirrors the torch/CUDA decode step for step."""
    freqs = np.asarray(freqs, np.uint32)
    cum, sym_tab = build_tables(freqs)
    cls = np.asarray(class_ids, np.int32)
    word_off = np.asarray(word_off, np.int64)
    n_syms = np.asarray(n_syms, np.int64)
    K = np.asarray(lanes, np.int64)
    S = len(n_syms)
    T = np.where(n_syms > 0, -(-n_syms // np.maximum(K, 1)), 0)
    T_max = int(T.max(initial=0))

    lane_idx = np.arange(k_max)[None, :]
    lane_ok = lane_idx < K[:, None]
    # initial states from the stream head
    st_idx = word_off[:, None] + 2 * np.minimum(lane_idx, K[:, None] - 1)
    states = (words[st_idx].astype(np.uint32)
              | (words[st_idx + 1].astype(np.uint32) << 16))
    data_off = word_off + 2 * K
    cursor = np.zeros(S, np.int64)
    out = np.zeros((S, max(T_max, 1) * k_max), np.uint8)

    for t in range(T_max):
        active = lane_ok & (t < T)[:, None]
        slot = states & _MASK
        s_t = sym_tab[cls[:, None], slot]
        F = freqs[cls[:, None], s_t]
        C = cum[cls[:, None], s_t]
        x = F * (states >> PROB_BITS) + slot - C
        renorm = active & (x < RANS_L)
        within = np.cumsum(renorm, axis=1) - renorm
        widx = np.clip(data_off[:, None] + cursor[:, None] + within,
                       0, len(words) - 1)
        w = words[widx].astype(np.uint32)
        x = np.where(renorm, (x << 16) | w, x)
        states = np.where(active, x, states)
        cursor += renorm.sum(axis=1)
        # scatter symbols: position t*K_s + lane for lane < K_s
        pos = t * K + 0  # (S,)
        cols = pos[:, None] + lane_idx
        valid = active
        rows = np.broadcast_to(np.arange(S)[:, None], valid.shape)
        out[rows[valid], cols[valid]] = s_t[valid].astype(np.uint8)

    return [out[s, :int(n_syms[s])].copy() for s in range(S)]


def gather_stream_bytes(out_row: np.ndarray, n: int, k: int,
                        k_max: int = MAX_LANES) -> np.ndarray:
    """Linearize one stream from the step-major (T*k_max) decode layout."""
    i = np.arange(n, dtype=np.int64)
    return np.asarray(out_row)[(i // k) * k_max + (i % k)].astype(np.uint8)
