"""Device-resident ACEAPEX decode on PyTorch (paper §3, Mode 2).

Mode 2 ("device"): entropy *and* match resolution on the device, archive
arrays resident in device memory — the full device-resident pipeline. A
block selection decodes in one rANS launch and one LZ77 match launch per
depth bucket (position-invariant random access, §4); whole-file decode
is the selection [0, n_blocks) in chunks.

This slice of the port covers self-contained ("ra") archives with the
"raise" failure semantics. Global/wavefront archives, Mode 1 (host
entropy), `on_error="repair"|"partial"` and streaming decode raise
`NotImplementedError` naming the slice that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import depth as dpth
from repro_torch.core.format import (FNV_OFFSET, STREAM_NAMES, Archive,
                                     file_digest)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import StreamLayout, rans_tables, stream_layout


class BlockDigestError(ValueError):
    """A decoded block's FNV-1a-64 digest does not match the archive's."""


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises
    (pass device="cpu" for the plain PyTorch versions of the kernels)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but no CUDA card is available; pass "
            f"device='cpu' to run the plain PyTorch versions of the kernels")
    return dev


def _not_in_slice(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the {slice_name} slice of "
        f"the PyTorch port")


def check_on_error(on_error: str) -> str:
    if on_error in ("repair", "partial"):
        raise _not_in_slice(f'on_error="{on_error}"', "self-healing")
    if on_error != "raise":
        raise ValueError(f"on_error must be 'raise', 'repair' or 'partial', "
                         f"got {on_error!r}")
    return on_error


def _pad_pow2(ids: np.ndarray) -> np.ndarray:
    """Pad a request batch to the next power of two; pad slots repeat the
    last element, so they add no unique blocks. Kept from the reference
    so `decoded_blocks_last` counts the same blocks."""
    n = ids.size
    cap = 1 << max(0, n - 1).bit_length() if n > 1 else 1
    if cap == n:
        return ids
    return np.concatenate([ids, np.full(cap - n, ids[-1], ids.dtype)])


# --------------------------------------------------------------- device form
@dataclasses.dataclass
class DeviceArchive:
    """The compressed archive resident in device memory plus its static
    decode geometry (python ints)."""
    words: torch.Tensor         # i16[W] — the u16 word buffer's bits
    word_off: torch.Tensor      # i64[n_blocks, 4]
    n_syms: torch.Tensor        # i32[n_blocks, 4]
    lanes: torch.Tensor         # i32[n_blocks, 4]
    n_cmds: torch.Tensor        # i32[n_blocks]
    block_start: torch.Tensor   # i64[n_blocks]
    block_len: torch.Tensor     # i32[n_blocks]
    tables: tuple               # rANS decode tables (`rans_tables`)
    block_size: int
    n_blocks: int
    raw_size: int
    entropy: str
    max_cmds: int               # padding geometry of the command planes
    offset_bytes: int
    max_depth: Optional[int] = None       # archive-wide resolve-round bound
    block_depth: Optional[np.ndarray] = None  # host i32 per-block depths

    @property
    def device(self) -> torch.device:
        return self.words.device

    @property
    def layout(self) -> StreamLayout:
        """Segments of a block's decoded streams in one (B, row) u8 row."""
        return stream_layout(self.block_size, self.max_cmds,
                             self.offset_bytes)

    @property
    def device_bytes(self) -> int:
        return sum(f.numel() * f.element_size()
                   for f in (self.words, self.word_off, self.n_syms,
                             self.lanes, self.n_cmds, self.block_start,
                             self.block_len))


def to_device(a: Archive, device="cuda") -> DeviceArchive:
    """Upload an "ra" archive to `device` (default: the card)."""
    dev = resolve_device(device)
    if a.mode != "ra":
        raise _not_in_slice('mode="global" (wavefront) decode',
                            "global-wavefront")

    def up(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x, dt)).to(dev)

    return DeviceArchive(
        words=up(np.asarray(a.words, np.uint16).view(np.int16), np.int16),
        word_off=up(a.word_off, np.int64),
        n_syms=up(a.n_syms, np.int32),
        lanes=up(a.lanes, np.int32),
        n_cmds=up(a.n_cmds, np.int32),
        block_start=up(a.block_start, np.int64),
        block_len=up(a.block_len, np.int32),
        tables=rans_tables(a.freqs, dev),
        block_size=int(a.block_size),
        n_blocks=int(a.n_blocks),
        raw_size=int(a.raw_size),
        entropy=a.entropy,
        max_cmds=int(a.n_cmds.max(initial=1)),
        offset_bytes=int(a.offset_bytes),
        max_depth=a.max_depth,
        block_depth=(np.asarray(a.block_depth, np.int32)
                     if a.block_depth is not None else None),
    )


# ------------------------------------------------------------ stream extract
def _rans_inputs(da: DeviceArchive, sel: torch.Tensor) -> dict:
    """Arguments of the rANS kernel for the 4 streams of each selected
    block: the selection's (B, 4) stream tables."""
    return dict(words=da.words, word_off=da.word_off[sel],
                n_syms=da.n_syms[sel], lanes=da.lanes[sel], tables=da.tables,
                layout=da.layout)


def _entropy_decode_sel(da: DeviceArchive, sel: torch.Tensor) -> dict:
    """rANS/raw decode of the 4 streams of each selected block.

    Returns per-block linear stream bytes: literals (B, block_size),
    lengths (B, 2*max_cmds), offsets (B, offset_bytes*max_cmds), commands
    (B, 2*max_cmds) — for rANS, column views of the kernel's one
    (B, layout.row) output."""
    if da.entropy != "raw":
        return da.layout.split(ops.rans_decode_streams(**_rans_inputs(da,
                                                                      sel)))
    nsym = da.n_syms[sel]
    woff = da.word_off[sel]
    W = da.words.shape[0]

    def unpack(col, out_len):
        nw = (out_len + 1) // 2
        idx = (woff[:, col, None]
               + torch.arange(nw, device=da.device)[None, :]).clamp(0, W - 1)
        w = da.words[idx].to(torch.int32) & 0xFFFF
        b = torch.stack([w & 0xFF, w >> 8], dim=2).reshape(
            sel.shape[0], -1)[:, :out_len]
        i = torch.arange(out_len, device=da.device)[None, :]
        return torch.where(i < nsym[:, col, None].long(), b,
                           0).to(torch.uint8)

    return {name: unpack(col, n) for col, (name, n) in
            enumerate(zip(STREAM_NAMES, da.layout.widths))}


# ------------------------------------------------------------------- decode
def _match_inputs(da: DeviceArchive, streams: dict,
                  sel: torch.Tensor) -> dict:
    """Arguments of the LZ77 match kernel: the stream bytes as decoded
    (the kernel reads the command byte planes itself) and the block
    geometry."""
    return dict(**streams, n_cmds=da.n_cmds[sel],
                block_len=da.block_len[sel], out_size=da.block_size,
                max_cmds=da.max_cmds, offset_bytes=da.offset_bytes)


def _decode_sel_core(da: DeviceArchive, sel: torch.Tensor,
                     n_rounds: Optional[int]) -> torch.Tensor:
    """Mode-2 block-selection decode: one entropy launch, one match launch
    of `n_rounds` resolve rounds (None = early exit). → (B, block_size)."""
    streams = _entropy_decode_sel(da, sel)
    return ops.lz77_decode_planes(**_match_inputs(da, streams, sel),
                                  n_rounds=n_rounds)


# ------------------------------------------------------------ digest verify
_M32 = 0xFFFFFFFF


def _fnv_mul_u32(hi: torch.Tensor, lo: torch.Tensor):
    """(hi, lo) u32 pair (held in i64) × FNV prime (2^40 + 0x1B3) mod 2^64,
    in 16-bit limbs."""
    m = 0x1B3
    c0 = (lo & 0xFFFF) * m
    c1 = (lo >> 16) * m + (c0 >> 16)
    c2 = (hi & 0xFFFF) * m + (c1 >> 16)
    c3 = (hi >> 16) * m + (c2 >> 16)
    t_lo = (c0 & 0xFFFF) | ((c1 & 0xFFFF) << 16)
    t_hi = (c2 & 0xFFFF) | ((c3 & 0xFFFF) << 16)
    # + (value << 40) mod 2^64: only the low word contributes
    return (t_hi + ((lo << 8) & _M32)) & _M32, t_lo


def _fnv_rows_core(rows: torch.Tensor, block_len: torch.Tensor):
    """(B, S) u8 decoded rows → per-row 8-byte-stride FNV-1a-64 as (hi, lo)
    u32 halves in i64: the device twin of `format.fnv1a64_u64_stride` over
    each row's first block_len bytes."""
    B, S = rows.shape
    dev = rows.device
    i = torch.arange(S, device=dev)[None, :]
    masked = torch.where(i < block_len.long()[:, None], rows, 0)
    pad = (-S) % 8
    if pad:
        masked = torch.nn.functional.pad(masked, (0, pad))
    g = masked.reshape(B, -1, 8).long()
    w_lo = g[..., 0] | (g[..., 1] << 8) | (g[..., 2] << 16) | (g[..., 3] << 24)
    w_hi = g[..., 4] | (g[..., 5] << 8) | (g[..., 6] << 16) | (g[..., 7] << 24)
    n_words = (block_len.long() + 7) // 8
    off = int(FNV_OFFSET)
    hi = torch.full((B,), off >> 32, dtype=torch.long, device=dev)
    lo = torch.full((B,), off & _M32, dtype=torch.long, device=dev)
    for t in range(w_lo.shape[1]):
        nhi, nlo = _fnv_mul_u32(hi ^ w_hi[:, t], lo ^ w_lo[:, t])
        live = t < n_words
        hi = torch.where(live, nhi, hi)
        lo = torch.where(live, nlo, lo)
    return hi, lo


class Decoder:
    """Archive resident on the device; block-selection decode.

    decode_blocks(sel) → (B, block_size) uint8 tensor on the device
    decode_all() / decode_range(lo, hi) → host bytes (numpy)

    `decoded_blocks_last` records how many blocks the most recent decode
    call materialized; `launch_rounds_last` the resolve-round count of
    every match launch it issued, in launch order (None = early exit).
    """

    def __init__(self, archive: Archive, device="cuda"):
        self.archive = archive
        self.da = to_device(archive, device)
        self.device = self.da.device
        self._store_view = None
        self.decoded_blocks_last = 0
        self.launch_rounds_last: list = []
        # depth-bucketed round schedule: per-block resolve-round counts,
        # pow2-bucketed archive-wide (core.depth.scheduled_rounds), so a
        # selection decodes in one match launch per distinct scheduled
        # count. None = legacy depth-free archive: every launch keeps the
        # early-exit resolver.
        bd = self.da.block_depth
        self._block_rounds = (None if bd is None
                              else dpth.scheduled_rounds(bd))
        # archives whose blocks all share one scheduled count cannot
        # benefit from bucketing — executors read this to skip the host
        # covering-set math
        self.multi_bucket = (self._block_rounds is not None
                             and np.unique(self._block_rounds).size > 1)

    def _api_store(self):
        """Store-shaped adapter over this decoder so the host APIs ride the
        query plane without duplicating the device archive."""
        if self._store_view is None:
            from repro_torch.api.executors import (DeviceExecutor,
                                                   _DecoderStore)
            from repro_torch.api.plan import QueryPlanner
            self._store_view = _DecoderStore(self)
            self._store_view.planner = QueryPlanner(self._store_view)
            self._store_view.executor = DeviceExecutor(self._store_view)
        return self._store_view

    # ------------------------------------------------- depth-bucket schedule
    @property
    def block_rounds(self) -> Optional[np.ndarray]:
        """i32[n_blocks] scheduled resolve rounds per block (pow2 depth
        buckets), or None for legacy depth-free archives."""
        return self._block_rounds

    def _ra_groups(self, sel_np: np.ndarray) -> Optional[list]:
        """Partition a selection by scheduled rounds: [(n_rounds,
        idx-into-sel)] ascending. None = no bucketing possible or useful
        (legacy archive, empty selection, or one group already at the
        archive-wide bound)."""
        if self._block_rounds is None or sel_np.size == 0:
            return None
        r = self._block_rounds[sel_np]
        vals = np.unique(r)
        if vals.size == 1 and int(vals[0]) == (self.da.max_depth or 0):
            return None
        return [(int(v), np.flatnonzero(r == v)) for v in vals]

    # ------------------------------------------------------------ verify
    def check_digests(self, sel, got: np.ndarray) -> None:
        """Compare computed u64 digests against the archive's `block_fnv`
        table at block ids `sel`; raises `BlockDigestError` naming the
        first mismatching block."""
        sel = np.asarray(sel, np.int64).reshape(-1)
        got = np.asarray(got, np.uint64).reshape(-1)
        if sel.size == 0:
            return
        want = self.archive.block_fnv[sel]
        bad = np.flatnonzero(got != want)
        if bad.size:
            b = int(sel[bad[0]])
            raise BlockDigestError(
                f"block {b} digest mismatch: decoded "
                f"{int(got[bad[0]]):#018x} != stored "
                f"{int(want[bad[0]]):#018x} "
                f"({bad.size} of {sel.size} selected blocks corrupt)")

    def verify_rows(self, sel, rows: torch.Tensor) -> None:
        """Recompute each decoded row's 8-byte-stride FNV-1a-64 on the
        device and compare against `block_fnv`; raises `BlockDigestError`
        naming the first mismatching block."""
        sel = np.asarray(sel, np.int64).reshape(-1)
        if sel.size == 0:
            return
        self.check_digests(sel, self._row_digests(sel, rows))

    def _row_digests(self, sel: np.ndarray, rows: torch.Tensor) -> np.ndarray:
        blen = torch.from_numpy(
            np.ascontiguousarray(self.archive.block_len[sel], np.int32)
        ).to(self.device)
        hi, lo = _fnv_rows_core(rows, blen)
        return ((hi.cpu().numpy().astype(np.uint64) << np.uint64(32))
                | lo.cpu().numpy().astype(np.uint64))

    # ------------------------------------------------------------ decode
    def _assemble_ra_groups(self, sel_np: np.ndarray, groups: list,
                            pad_groups: bool) -> torch.Tensor:
        """Depth-bucketed decode: one match launch per scheduled-rounds
        group, reassembled in the selection's original order. `pad_groups`
        pow2-pads each group as the reference does, so
        `decoded_blocks_last` counts the same blocks."""
        pieces, order, n_mat = [], [], 0
        for rounds, idx in groups:
            gsel = sel_np[idx]
            g = _pad_pow2(gsel) if pad_groups else gsel
            rows = _decode_sel_core(self.da, self._sel_tensor(g), rounds)
            self.launch_rounds_last.append(rounds)
            n_mat += int(g.size)
            pieces.append(rows[:idx.size])
            order.append(idx)
        order = np.concatenate(order)
        inv = np.empty(order.size, np.int64)
        inv[order] = np.arange(order.size)
        self.decoded_blocks_last = n_mat
        return torch.cat(pieces, dim=0)[self._sel_tensor(inv)]

    def _sel_tensor(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(ids, np.int64)).to(
            self.device)

    def decode_blocks(self, sel, verify: bool = False,
                      pad_groups: bool = True,
                      on_error: str = "raise") -> torch.Tensor:
        """Mode-2 decode of block ids `sel` → (B, block_size) u8 rows on
        the device; `verify` digest-checks every row (raising
        `BlockDigestError`)."""
        check_on_error(on_error)
        sel_np = np.asarray(sel, np.int64).reshape(-1)
        if sel_np.size and (sel_np.min() < 0
                            or sel_np.max() >= self.da.n_blocks):
            raise IndexError(f"block ids outside [0, {self.da.n_blocks})")
        self.launch_rounds_last = []
        if sel_np.size == 0:
            self.decoded_blocks_last = 0
            return torch.zeros((0, self.da.block_size), dtype=torch.uint8,
                               device=self.device)
        groups = self._ra_groups(sel_np)
        if groups is None:
            rows = _decode_sel_core(self.da, self._sel_tensor(sel_np),
                                    self.da.max_depth)
            self.launch_rounds_last.append(self.da.max_depth)
            self.decoded_blocks_last = int(sel_np.size)
        else:
            rows = self._assemble_ra_groups(sel_np, groups, pad_groups)
        if verify:
            self.verify_rows(sel_np, rows)
        return rows

    def decode_blocks_host_entropy(self, sel, verify: bool = False,
                                   pad_groups: bool = True,
                                   on_error: str = "raise"):
        raise _not_in_slice("Mode 1 (host-entropy) decode", "Mode 1")

    # ------------------------------------------------------------ host APIs
    def decode_range(self, lo: int, hi: int, mode2: bool = True) -> np.ndarray:
        """Decode output byte range [lo, hi) — touches only covering blocks.
        A one-ByteRange plan through the query plane."""
        from repro_torch.api.address import ByteRange
        view = self._api_store()
        plan = view.planner.plan([ByteRange(lo, hi)])
        rows, lens = view.executor.run(plan, mode2=mode2)
        return rows[0, :int(lens[0])].cpu().numpy()

    def decode_all(self, chunk_blocks: Optional[int] = None,
                   mode2: bool = True, verify: bool = False,
                   on_error: str = "raise") -> np.ndarray:
        """Whole-file decode to host bytes, `chunk_blocks` blocks per
        `decode_blocks` call (never more than one chunk of decoded output
        on the device at a time, paper §5 v7-RA).

        verify=True first checks `file_fnv` over the block digest table,
        then digest-checks every decoded block on the device; a mismatch
        raises `BlockDigestError`."""
        if not mode2:
            raise _not_in_slice("Mode 1 (host-entropy) decode", "Mode 1")
        check_on_error(on_error)
        a = self.archive
        out = np.empty(self.da.raw_size, np.uint8)
        if self.da.raw_size == 0:
            return out
        if verify and file_digest(a.block_fnv) != a.file_fnv:
            raise BlockDigestError(
                f"file digest mismatch: block digest table folds to "
                f"{file_digest(a.block_fnv):#018x} != stored "
                f"{a.file_fnv:#018x}")
        step = int(chunk_blocks or self.da.n_blocks)
        cols = torch.arange(self.da.block_size, device=self.device)[None, :]
        pos = 0
        for lo in range(0, self.da.n_blocks, step):
            sel = np.arange(lo, min(lo + step, self.da.n_blocks))
            rows = self.decode_blocks(sel, verify=verify)
            keep = cols < self.da.block_len[lo:lo + sel.size].long()[:, None]
            part = rows[keep]                 # rows cropped to block_len
            # one device-to-host copy straight into the output
            torch.from_numpy(out[pos:pos + part.numel()]).copy_(part)
            pos += part.numel()
        return out
