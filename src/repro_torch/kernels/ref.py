"""Plain PyTorch versions of the two decode kernels.

These are the oracles the CUDA kernels are held against, and what the
kernel wrappers in `kernels.ops` run for tensors that live on the CPU.
They compute the kernels' functions from the reference's steps and are
no yardstick of speed:

  * `rans_decode_streams_ref` = `rans_decode_ref` (step-major rows, the
    Pallas kernel's output) followed by `linearize` of each stream into
    its segment of the `StreamLayout` row;
  * `lz77_decode_planes_ref` = `planes_le` of the command byte planes
    followed by `lz77_decode_blocks_ref` (i32 command columns, the
    Pallas kernel's input).

The LZ77 match phase: command expansion is a scatter + cumsum, match
self-overlap folds via the modulo trick, and cross-command dependencies
resolve with pointer doubling. Resolution rounds come in two flavours:

  * fixed (`n_rounds = int`) — the archive's recorded chain depth or a
    depth bucket's round count (`core.depth.scheduled_rounds`);
  * early-exit (`n_rounds = None`) — stop after the round in which no
    pointer moved, capped at `log2_rounds(out_size)` so a malformed
    archive whose pointers form a cycle cannot hang the decode.

`lz77_decode_global_ref` resolves a contiguous global (wavefront) window
in one flat pointer space. It is no kernel's plain version: the
reference resolves global windows in plain array code on every backend,
and the port does the same on the CPU and the card.

All functions are batched over a leading block/stream axis (PyTorch has
no vmap on this path; the batch dimension is written out).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.depth import log2_rounds
from repro_torch.core.entropy import build_tables
from repro_torch.core.format import (MAX_LANES, N_STREAMS, PROB_BITS,
                                     PROB_SCALE, RANS_L, STREAM_NAMES)

__all__ = ["log2_rounds", "expand_pointers", "resolve_rounds",
           "lz77_decode_blocks_ref", "lz77_decode_global_ref", "planes_le",
           "lz77_decode_planes_ref",
           "StreamLayout", "stream_layout", "linearize", "rans_tables",
           "rans_decode_ref", "rans_decode_streams_ref"]

_M32 = 0xFFFFFFFF


# ------------------------------------------------------------ stream layout
class StreamLayout(NamedTuple):
    """Where each decoded stream of a block lies in its (B, row) u8 row:
    segment c spans [starts[c], starts[c + 1]) and holds up to widths[c]
    stream bytes, zero after them; starts[4] is the row width, a multiple
    of 16 so every row starts 16-byte aligned."""
    starts: Tuple[int, int, int, int, int]
    widths: Tuple[int, int, int, int]

    @property
    def row(self) -> int:
        return self.starts[N_STREAMS]

    def split(self, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, row) stream rows → {stream name: (B, width) column view}."""
        return {name: rows[:, s:s + w] for name, s, w in
                zip(STREAM_NAMES, self.starts, self.widths)}


def stream_layout(block_size: int, max_cmds: int,
                  offset_bytes: int) -> StreamLayout:
    """[literals: block_size | lengths: 2·max_cmds | offsets:
    offset_bytes·max_cmds | commands: 2·max_cmds], padded to 16 bytes."""
    widths = (block_size, 2 * max_cmds, offset_bytes * max_cmds,
              2 * max_cmds)
    starts = [0]
    for w in widths:
        starts.append(starts[-1] + w)
    starts[-1] = -(-starts[-1] // 16) * 16
    return StreamLayout(tuple(starts), widths)


# --------------------------------------------------------------- LZ77 match
def expand_pointers(lit_lens: torch.Tensor, match_lens: torch.Tensor,
                    offsets: torch.Tensor, n_cmds: torch.Tensor,
                    block_len: torch.Tensor, out_size: int,
                    base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-output-byte source pointers for a batch of blocks.

    `offsets` and the returned match pointers live in the coordinate space
    `base + local`: no `base` with block-local offsets ("ra" blocks), or
    the blocks' (B,) starts with window-relative offsets (global mode).

    (B, C) command planes → i64[B, out_size]: ptr >= 0 copies from
    position ptr; ptr < 0 is literal index -(ptr + 1). Bytes >= block_len
    get literal 0 (ptr = -1).
    """
    B, C = lit_lens.shape
    dev = lit_lens.device
    cmd_ids = torch.arange(C, device=dev)
    valid = cmd_ids[None, :] < n_cmds.long()[:, None]
    ll = torch.where(valid, lit_lens.long(), 0)
    ml = torch.where(valid, match_lens.long(), 0)
    off = offsets.long()

    tot = ll + ml
    cum_tot = torch.cumsum(tot, dim=1)              # command end positions
    P = cum_tot - tot                               # command start positions
    cum_lit = torch.cumsum(ll, dim=1) - ll          # literal base per command

    # command-of-byte via scatter(+1 at command ends) then cumsum
    ends = torch.where(valid, cum_tot.clamp(max=out_size), out_size)
    marks = torch.zeros(B, out_size + 1, dtype=torch.long, device=dev)
    marks.scatter_add_(1, ends, valid.long())
    cmd_of = torch.cumsum(marks, dim=1)[:, :out_size].clamp(max=C - 1)

    i = torch.arange(out_size, device=dev)[None, :]
    P_c = torch.gather(P, 1, cmd_of)
    ll_c = torch.gather(ll, 1, cmd_of)
    off_c = torch.gather(off, 1, cmd_of)
    rel = i - P_c
    is_lit = rel < ll_c
    lit_idx = torch.gather(cum_lit, 1, cmd_of) + rel
    # match source with self-overlap folding (dest start in `base` coords)
    mstart = P_c + ll_c
    if base is not None:
        mstart = mstart + base.long()[:, None]
    d = (mstart - off_c).clamp(min=1)               # distance >= 1
    mptr = off_c + torch.remainder(rel - ll_c, d)
    ptr = torch.where(is_lit, -(lit_idx + 1), mptr)
    return torch.where(i < block_len.long()[:, None], ptr, -1)


def _double_round(p: torch.Tensor) -> torch.Tensor:
    nxt = torch.gather(p, 1, p.clamp(0, p.shape[1] - 1))
    return torch.where(p >= 0, nxt, p)


def resolve_rounds(ptr: torch.Tensor,
                   n_rounds: Optional[int] = None) -> torch.Tensor:
    """The pointer-doubling recurrence over (B, N) pointer rows.

    `n_rounds=None` runs until no pointer moves, capped at
    `log2_rounds(N)`: any valid parse converges within that, so the cap
    only stops a cyclic (malformed) archive from looping forever — digest
    verification then reports the corruption. A round that moves nothing
    is a fixpoint, so stopping there gives the same bytes as running on."""
    if n_rounds is not None:
        for _ in range(int(n_rounds)):
            ptr = _double_round(ptr)
        return ptr
    cap = log2_rounds(ptr.shape[1])
    moving = bool((ptr >= 0).any())
    r = 0
    while moving and r < cap:
        nxt = _double_round(ptr)
        moving = bool((nxt != ptr).any())
        ptr = nxt
        r += 1
    return ptr


def lz77_decode_blocks_ref(lit_lens, match_lens, offsets, n_cmds, literals,
                           block_len, out_size: int,
                           n_rounds: Optional[int] = None) -> torch.Tensor:
    """(B, C) i32 command planes + (B, L) u8 literals → (B, out_size) u8."""
    ptr = expand_pointers(lit_lens, match_lens, offsets, n_cmds, block_len,
                          out_size)
    ptr = resolve_rounds(ptr, n_rounds)
    lit_idx = (-ptr - 1).clamp(0, literals.shape[1] - 1)
    return torch.gather(literals, 1, lit_idx)


# elements per slab of the global resolve's pointer expansion (2 Mi: each
# of a slab's i64 temporaries stays at 16 MiB)
EXPAND_SLAB = 1 << 21


def lz77_decode_global_ref(lit_lens, match_lens, offsets, n_cmds, literals,
                           lit_base, block_start, block_len, out_size: int,
                           total_size: int,
                           n_rounds: Optional[int] = None) -> torch.Tensor:
    """Wavefront decode of a contiguous global window: every block's
    pointers in one flat (total_size,) output space, so chains may cross
    blocks. `offsets` and `block_start` are window-relative; `literals`
    is (B, L) u8 and `lit_base` the (B,) flat literal index of each row's
    first literal. `n_rounds` doubling rounds over the whole window (None
    = early exit). → (total_size,) u8.

    Not the plain version of a kernel: the reference resolves global
    windows in plain array code on every backend, and so does the port."""
    B = lit_lens.shape[0]
    dev = lit_lens.device
    bstart = block_start.long()
    i = torch.arange(out_size, device=dev)[None, :]
    flat = torch.full((total_size,), -1, dtype=torch.long, device=dev)
    # pointers expand in slabs of rows: the expansion's dozen (rows,
    # out_size) i64 temporaries then stay a slab's size, not the window's
    step = max(1, EXPAND_SLAB // max(out_size, 1))
    for lo in range(0, B, step):
        rs = slice(lo, lo + step)
        ptr = expand_pointers(lit_lens[rs], match_lens[rs], offsets[rs],
                              n_cmds[rs], block_len[rs], out_size,
                              base=bstart[rs])
        # match pointers are window positions already; literal indices
        # shift by the row's flat literal base
        is_lit = ptr < 0
        gl = (-(torch.where(is_lit, ptr, -1) + 1)
              + lit_base[rs].long()[:, None])
        gptr = torch.where(is_lit, -(gl + 1), ptr)
        keep = i < block_len[rs].long()[:, None]
        pos = (bstart[rs, None] + i)[keep]
        inside = (pos >= 0) & (pos < total_size)
        flat[pos[inside]] = gptr[keep][inside]
    flat = resolve_rounds(flat[None, :], n_rounds)[0]
    lit_flat = literals.reshape(-1)
    return lit_flat[(-flat - 1).clamp(0, lit_flat.shape[0] - 1)]


def planes_le(planes: torch.Tensor, n_cmds: torch.Tensor, max_cmds: int,
              n_planes: int, mask_top: bool) -> torch.Tensor:
    """Little-endian value of the first `n_planes` byte planes → (B,
    max_cmds) i64; plane b of command j sits at column b * n_cmds + j
    (clamped into the row), columns past n_cmds are 0. `mask_top` clears
    bit 31 (device decode addresses stay < 2^31); without it four planes
    give the full low 32 bits, unsigned."""
    nc = n_cmds.long()[:, None]
    j = torch.arange(max_cmds, device=planes.device)[None, :]
    p = planes.long()
    v = torch.zeros((planes.shape[0], max_cmds), dtype=torch.long,
                    device=planes.device)
    for b in range(n_planes):
        idx = (b * nc + j).clamp(max=planes.shape[1] - 1)
        byte = torch.gather(p, 1, idx)
        if b == 3 and mask_top:
            byte = byte & 0x7F
        v = v | (byte << (8 * b))
    return torch.where(j < nc, v, 0)


def lz77_decode_planes_ref(literals, lengths, offsets, commands, n_cmds,
                           block_len, out_size: int, max_cmds: int,
                           offset_bytes: int,
                           n_rounds: Optional[int] = None) -> torch.Tensor:
    """(B, ·) u8 byte planes of the literal-length (`commands`),
    match-length (`lengths`) and offset streams + (B, L) u8 literals →
    (B, out_size) u8. The offsets take the first min(4, offset_bytes)
    planes, bit 31 masked at four."""
    n_off = min(4, int(offset_bytes))
    return lz77_decode_blocks_ref(
        planes_le(commands, n_cmds, max_cmds, 2, False),
        planes_le(lengths, n_cmds, max_cmds, 2, False),
        planes_le(offsets, n_cmds, max_cmds, n_off, n_off == 4),
        n_cmds, literals, block_len, out_size, n_rounds=n_rounds)


# ------------------------------------------------------------- rANS decode
def rans_tables(freqs, device) -> Tuple[torch.Tensor, ...]:
    """(C, 256) normalized frequencies → device decode tables
    (freq u16-valued i16 [C, 256], exclusive cum i16 [C, 256], symbol of
    slot u8 [C, PROB_SCALE], and the kernel's packed slot table i32 [C,
    PROB_SCALE]: sym | (freq[sym] - 1) << 8 | (slot - cum[sym]) << 20).
    Built once per archive. The plain version reads the first three; the
    packing is exact because `build_tables` gives every slot a symbol with
    cum <= slot < cum + freq <= PROB_SCALE."""
    freqs_np = np.asarray(freqs, np.uint32)
    cum, sym = build_tables(freqs_np)
    rows = np.arange(freqs_np.shape[0])[:, None]
    slots = (sym.astype(np.uint32)
             | (freqs_np[rows, sym] - 1) << 8
             | (np.arange(PROB_SCALE, dtype=np.uint32)[None, :]
                - cum[rows, sym]) << 20)
    as_dev = lambda a, dt: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a.astype(dt))).to(device)
    # PROB_SCALE = 4096 bounds every freq and cum value, so i16 is exact
    return (as_dev(freqs_np, np.int16), as_dev(cum, np.int16),
            as_dev(sym, np.uint8), as_dev(slots.view(np.int32), np.int32))


def rans_decode_ref(words: torch.Tensor, word_off: torch.Tensor,
                    n_syms: torch.Tensor, lanes: torch.Tensor,
                    class_ids: torch.Tensor, tables, t_max: int,
                    k_max: int = MAX_LANES
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lane-interleaved rANS decode of S streams, in int64 with 32-bit
    masks (the torch unsigned types lack `>>`, `+` and `<`).

    `words` holds the u16 word buffer as i16 bits. Returns (rows, T):
    rows is (S, max(t_max, 1) * k_max) u8 where symbol i of stream s is at
    rows[s, (i // K_s) * k_max + (i % K_s)] — step-major, lane-minor — and
    every other position is 0; T is the per-stream step count.
    """
    freq_t, cum_t, sym_t = (t.long() for t in tables[:3])
    dev = words.device
    w = words.long() & 0xFFFF
    W = w.shape[0]
    cls = class_ids.long()[:, None]
    woff = word_off.long()
    n = n_syms.long()
    K = lanes.long().clamp(min=1)
    S = n.shape[0]
    T = torch.where(n > 0, -(-n // K), 0)
    steps = max(int(t_max), 1)

    lane = torch.arange(k_max, device=dev)[None, :]
    lane_ok = lane < K[:, None]
    st_idx = (woff[:, None] + 2 * torch.minimum(lane, K[:, None] - 1)
              ).clamp(0, max(W - 2, 0))
    states = w[st_idx] | (w[st_idx + 1] << 16)
    data_off = woff + 2 * K
    cursor = torch.zeros(S, dtype=torch.long, device=dev)
    out = torch.zeros(S, steps * k_max, dtype=torch.uint8, device=dev)
    for t in range(int(t_max)):
        active = lane_ok & (t < T)[:, None]
        slot = states & (PROB_SCALE - 1)
        s_t = sym_t[cls, slot]
        x = (freq_t[cls, s_t] * (states >> PROB_BITS) + slot
             - cum_t[cls, s_t]) & _M32
        renorm = active & (x < RANS_L)
        within = torch.cumsum(renorm.long(), dim=1) - renorm.long()
        widx = (data_off[:, None] + cursor[:, None] + within).clamp(0, W - 1)
        x = torch.where(renorm, ((x << 16) | w[widx]) & _M32, x)
        states = torch.where(active, x, states)
        cursor = cursor + renorm.sum(dim=1)
        out[:, t * k_max:(t + 1) * k_max] = torch.where(
            active, s_t, 0).to(torch.uint8)
    return out, T.to(torch.int32)


def linearize(rows: torch.Tensor, n: torch.Tensor, k: torch.Tensor,
              out_len: int, k_max: int = MAX_LANES) -> torch.Tensor:
    """rows (B, T*k_max) step-major rANS output → (B, out_len) linear bytes.

    Symbol i lives at (i // K) * k_max + (i % K); i >= n → 0.
    """
    i = torch.arange(out_len, device=rows.device)[None, :]
    k = k.long().clamp(min=1)[:, None]
    idx = ((i // k) * k_max + (i % k)).clamp(0, rows.shape[1] - 1)
    vals = torch.gather(rows, 1, idx)
    return torch.where(i < n.long()[:, None], vals, 0)


def rans_decode_streams_ref(words: torch.Tensor, word_off: torch.Tensor,
                            n_syms: torch.Tensor, lanes: torch.Tensor,
                            tables, layout: StreamLayout) -> torch.Tensor:
    """The 4 streams of each of B blocks ((B, 4) stream tables, class =
    stream column) → (B, layout.row) u8 linear stream rows: stream c's
    first min(n, widths[c]) symbols at the start of segment c, zeros to
    the next segment. Lane counts are clamped to [1, MAX_LANES]."""
    B = word_off.shape[0]
    dev = words.device
    K = lanes.clamp(1, MAX_LANES)
    widths = torch.tensor(layout.widths, device=dev)[None, :]
    n_out = torch.minimum(n_syms.long().clamp(min=0), widths)
    steps = -(-n_out // K.long())
    t_max = int(steps.max()) if B else 0
    rows, _ = rans_decode_ref(
        words, word_off.reshape(-1), n_syms.reshape(-1), K.reshape(-1),
        torch.arange(N_STREAMS, dtype=torch.int32, device=dev).repeat(B),
        tables, t_max)
    rows = rows.reshape(B, N_STREAMS, -1)
    out = torch.zeros((B, layout.row), dtype=torch.uint8, device=dev)
    for c, (s, w) in enumerate(zip(layout.starts, layout.widths)):
        out[:, s:s + w] = linearize(rows[:, c], n_syms[:, c], K[:, c], w)
    return out
