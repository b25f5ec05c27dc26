"""Device-resident ACEAPEX decode on PyTorch (paper §3).

Two modes, kept distinct as the paper insists (§3.1):

  Mode 1 ("host-entropy"): entropy decode on the host (numpy), match
      resolution on the device.
  Mode 2 ("device"): entropy *and* match resolution on the device, archive
      arrays resident in device memory — the full device-resident pipeline.

Both decode an arbitrary block selection (position-invariant random
access, §4). A self-contained ("ra") selection decodes in one rANS launch
and one LZ77 match launch per depth bucket. A global (wavefront)
selection decodes per anchor window (the whole prefix when anchor-free):
the rANS kernel, then one flat pointer space per window resolved in
plain PyTorch, as the reference resolves it. Whole-file decode streams
the selection [0, n_blocks) in chunks.

A verified decode digest-checks every row on the device and, on a
mismatch, runs the detect → recover → degrade loop per `on_error`:
"raise" (`BlockDigestError`), "repair" (parity reconstruction of the
payload, one re-decode through the same kernels, re-verify) or
"partial" (unrecoverable blocks quarantine and read back as zeros, with
`last_bad_blocks` naming them). See `repro_torch.resilience`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import depth as dpth
from repro_torch.core import entropy as ent
from repro_torch.core.format import (FNV_OFFSET, N_STREAMS, STREAM_NAMES,
                                     Archive, file_digest)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (StreamLayout, lz77_decode_global_ref,
                                     planes_le, rans_tables, stream_layout)
from repro_torch.resilience import check_on_error


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


def _pad_pow2(ids: np.ndarray) -> np.ndarray:
    """Pad a request batch to the next power of two; pad slots repeat the
    last element, so they add no unique blocks. Kept from the reference
    so `decoded_blocks_last` counts the same blocks."""
    n = ids.size
    cap = 1 << max(0, n - 1).bit_length() if n > 1 else 1
    if cap == n:
        return ids
    return np.concatenate([ids, np.full(cap - n, ids[-1], ids.dtype)])


def _check_window_bytes(first: int, last: int, block_size: int) -> None:
    """Both global window decodes (Mode 1 and Mode 2) resolve matches in
    ONE flat pointer space that the format bounds to int32 positions — a
    window spanning >= 2 GiB must be a loud error, not silent position
    overflow."""
    if (last - first + 1) * block_size >= 2**31:
        raise ValueError(
            f"decode window [{first}, {last}] spans "
            f"{(last - first + 1) * block_size} bytes >= 2 GiB — the flat "
            f"pointer space is int32; decode narrower ranges (or re-encode "
            f"with a smaller anchor_interval)")


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
    block_start: torch.Tensor   # i32[n_blocks] — low 32 bits of the 64-bit
                                # absolute starts (wraparound semantics:
                                # global windows rebase modulo 2^32, exact
                                # for any base because windows span
                                # < 2^31 bytes)
    block_len: torch.Tensor     # i32[n_blocks]
    tables: tuple               # rANS decode tables (`rans_tables`)
    block_size: int
    n_blocks: int
    raw_size: int
    mode: str                   # "ra" | "global"
    entropy: str
    max_cmds: int               # padding geometry of the command planes
    offset_bytes: int
    anchor_interval: int = 0    # wavefront restart spacing (0 = anchor-free)
    anchors: np.ndarray = dataclasses.field(      # host i64 anchor block
        default_factory=lambda: np.zeros(0, np.int64))  # ids (sorted)
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
    """Upload an archive to `device` (default: the card)."""
    dev = resolve_device(device)
    anchors = np.asarray(a.anchors, np.int64)
    if a.mode == "global" and anchors.size == 0 and a.raw_size >= 2**31:
        # anchor-free wavefront decode materializes ONE raw_size-byte flat
        # pointer space, which int32 positions cannot address past 2 GiB.
        # The plain-torch resolve holds it in int64 with its temporaries:
        # a 682 MB peak for a 16 MiB window on an H100 (chip_smoke.py);
        # PERF.md §5 gives the largest such archive an 80 GB card decodes.
        raise ValueError(
            f"anchor-free global archive spans {a.raw_size} bytes >= 2 GiB"
            f" — whole-prefix decode needs an int32 flat pointer space, "
            f"and its resolve about 41 device bytes per window byte at a "
            f"16 MiB window; re-encode with anchor_interval to bound "
            f"decode windows")

    def up(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x, dt)).to(dev)

    return DeviceArchive(
        words=up(np.asarray(a.words, np.uint16).view(np.int16), np.int16),
        word_off=up(a.word_off, np.int64),
        n_syms=up(a.n_syms, np.int32),
        lanes=up(a.lanes, np.int32),
        n_cmds=up(a.n_cmds, np.int32),
        # astype(int32) keeps the low 32 bits (numpy wraps), which is what
        # the window rebase needs for archives past 2 GiB
        block_start=up(np.asarray(a.block_start).astype(np.int32),
                       np.int32),
        block_len=up(a.block_len, np.int32),
        tables=rans_tables(a.freqs, dev),
        block_size=int(a.block_size),
        n_blocks=int(a.n_blocks),
        raw_size=int(a.raw_size),
        mode=a.mode,
        entropy=a.entropy,
        max_cmds=int(a.n_cmds.max(initial=1)),
        offset_bytes=int(a.offset_bytes),
        anchor_interval=int(a.anchor_interval),
        anchors=anchors,
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


def _entropy_decode_host(a: Archive, sel: np.ndarray,
                         max_cmds: int) -> dict:
    """Mode 1: entropy decode of the 4 streams of each selected block on
    the host (numpy) → {stream name: (B, width) u8 array}, each stream
    zero-padded or cut to its width (literals block_size, lengths and
    commands 2·max_cmds, offsets offset_bytes·max_cmds)."""
    sel = np.asarray(sel, np.int64).reshape(-1)
    B = sel.size
    idx = (sel[:, None] * N_STREAMS
           + np.arange(N_STREAMS)[None, :]).reshape(-1)
    woff = a.word_off.reshape(-1)[idx]
    nsym = a.n_syms.reshape(-1)[idx]
    if a.entropy == "raw":
        streams = []
        for o, n in zip(woff.tolist(), nsym.tolist()):
            w = a.words[o:o + (n + 1) // 2]
            b = np.stack([w & 0xFF, w >> 8], axis=1).reshape(-1)
            streams.append(b[:n].astype(np.uint8))
    else:
        streams = ent.rans_decode_batch_np(
            a.words, woff, nsym, a.lanes.reshape(-1)[idx],
            np.tile(np.arange(N_STREAMS, dtype=np.int32), B), a.freqs)
    widths = (a.block_size, 2 * max_cmds, a.offset_bytes * max_cmds,
              2 * max_cmds)
    out = {}
    for c, (name, width) in enumerate(zip(STREAM_NAMES, widths)):
        rows = np.zeros((B, width), np.uint8)
        for i in range(B):
            st = streams[i * N_STREAMS + c][:width]
            rows[i, :st.size] = st
        out[name] = rows
    return out


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


_M32 = 0xFFFFFFFF


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """i64 values → their residue modulo 2^32 read as a signed 32-bit
    integer: the reference's i32 wraparound subtraction, computed in int64
    so that every device gives the same answer."""
    return ((x & _M32) ^ 0x80000000) - 0x80000000


def _global_match(streams: dict, n_cmds: torch.Tensor,
                  block_len: torch.Tensor, block_start: torch.Tensor,
                  block_size: int, max_cmds: int, offset_bytes: int,
                  n_rounds: Optional[int]) -> torch.Tensor:
    """Match phase of a contiguous global window → (L, block_size) u8.

    The stored offsets (8 planes: their full low 32 bits) and the blocks'
    low-32-bit starts are rebased on the window's first block modulo 2^32
    — exact for any 64-bit base, because the anchor guarantee keeps every
    match source inside the window and windows span < 2^31 bytes — then
    one flat pointer space over the window resolves in plain PyTorch."""
    L = n_cmds.shape[0]
    n_off = min(4, offset_bytes)
    offsets = planes_le(streams["offsets"], n_cmds, max_cmds, n_off,
                        mask_top=offset_bytes == 4)
    start = block_start.long() & _M32
    base = start[0]
    lits = streams["literals"]
    flat = lz77_decode_global_ref(
        planes_le(streams["commands"], n_cmds, max_cmds, 2, False),
        planes_le(streams["lengths"], n_cmds, max_cmds, 2, False),
        _wrap_i32(offsets - base), n_cmds, lits,
        torch.arange(L, device=lits.device) * lits.shape[1],
        _wrap_i32(start - base), block_len, out_size=block_size,
        total_size=L * block_size, n_rounds=n_rounds)
    return flat.reshape(L, block_size)


def _decode_window_core(da: DeviceArchive, first: int, last: int,
                        n_rounds: Optional[int],
                        streams: Optional[dict] = None) -> torch.Tensor:
    """Decode the contiguous global window [first, last] →
    (last - first + 1, block_size) u8. `streams` are the window's decoded
    stream rows when the host decoded them (Mode 1); without them the
    rANS kernel decodes them on the device (Mode 2)."""
    wsel = torch.arange(first, last + 1, device=da.device)
    if streams is None:
        streams = _entropy_decode_sel(da, wsel)
    return _global_match(streams, da.n_cmds[wsel], da.block_len[wsel],
                         da.block_start[wsel], da.block_size, da.max_cmds,
                         da.offset_bytes, n_rounds)


# ------------------------------------------------------------ digest verify

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

    decode_blocks(sel) → (B, block_size) u8 tensor on the device (Mode 2)
    decode_blocks_host_entropy(sel) → the same, Mode 1
    decode_from_anchor(first, last) → anchor-window decode ("global")
    decode_all() / decode_range(lo, hi) → host bytes (numpy)

    `decoded_blocks_last` records how many blocks the most recent decode
    call materialized — for a checkpointed wavefront the summed anchor
    windows, not the prefix; `launch_rounds_last` the resolve-round count
    of every match launch or window resolve it issued, in order (None =
    early exit).
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
        # count. "ra" blocks schedule alone; global chains cross blocks, so
        # a global block takes its anchor window's bucketed max. None =
        # legacy depth-free archive: every launch keeps the early-exit
        # resolver.
        bd = self.da.block_depth
        if bd is None:
            self._block_rounds = None
        elif self.da.mode == "ra":
            self._block_rounds = dpth.scheduled_rounds(bd)
        else:
            anchors = self.da.anchors
            n_blocks = self.da.n_blocks
            win_of = (np.searchsorted(anchors, np.arange(n_blocks),
                                      "right") - 1
                      if anchors.size else np.zeros(n_blocks, np.int64))
            wdepth = np.zeros(int(win_of.max(initial=0)) + 1, np.int64)
            np.maximum.at(wdepth, win_of, bd.astype(np.int64))
            self._block_rounds = dpth.scheduled_rounds(wdepth)[win_of]
        # archives whose blocks all share one scheduled count cannot
        # benefit from bucketing — executors read this to skip the host
        # covering-set math
        self.multi_bucket = (self._block_rounds is not None
                             and np.unique(self._block_rounds).size > 1)
        # global mode, opt-in: each decode records (first block id, (L,
        # block_size) rows) per anchor window it materialized, so the
        # block cache can co-install the siblings it already paid for.
        # Off by default: holding decoded windows costs device memory.
        self.collect_window_rows = False
        self.last_window_rows: list = []
        # ---- detect → recover → degrade state ----
        # blocks proven unrecoverable under on_error="partial": never
        # re-decoded, never cache-installed; "raise"/"repair" requests
        # that touch them fail at once
        self.quarantined: set = set()
        self._recover = {"reconstructed": 0, "retries": 0,
                         "unrecoverable": 0}
        # block ids that failed (quarantined or zeroed) in the most recent
        # decode call — callers (cache invalidation, per-address outcomes)
        # read this right after the call
        self.last_bad_blocks = np.zeros(0, np.int64)
        # blocks that failed INITIAL verification in the most recent call,
        # even if later repaired: window rows collected before the repair
        # may hold their pre-repair garbage, so the cache co-install skips
        # them
        self.last_suspect_blocks = np.zeros(0, np.int64)
        # fault-injection hook: called once at the top of every decode
        # call when armed (repro_torch.resilience.faults.FaultInjector)
        self.fault_hook = None

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
        buckets; global blocks take their anchor window's), or None for
        legacy depth-free archives."""
        return self._block_rounds

    def _rounds_for_span(self, first: int, last: int) -> Optional[int]:
        """Scheduled rounds of the contiguous window decode [first, last]:
        the max over its blocks."""
        if self._block_rounds is None:
            return self.da.max_depth        # None: legacy early exit
        return int(self._block_rounds[first:last + 1].max(initial=0))

    def _ra_groups(self, sel_np: np.ndarray) -> Optional[list]:
        """Partition an "ra" selection by scheduled rounds: [(n_rounds,
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
    def _sel_tensor(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(ids, np.int64)).to(
            self.device)

    def _host_streams(self, sel: np.ndarray) -> dict:
        """Mode 1 stream rows of `sel`, decoded on the host and uploaded
        as one (B, width) u8 tensor per stream."""
        return {k: torch.from_numpy(v).to(self.device) for k, v in
                _entropy_decode_host(self.archive, sel,
                                     self.da.max_cmds).items()}

    # ------------------------------------------- recover / degrade
    def recover_info(self) -> dict:
        """Cumulative recovery counters: `reconstructed` (blocks healed
        by parity + re-verified bit-perfect), `retries` (recovery decode
        passes), `unrecoverable` (blocks that stayed corrupt after
        reconstruction), `quarantined` (currently quarantined blocks)."""
        info = dict(self._recover)
        info["quarantined"] = len(self.quarantined)
        return info

    def heal_blocks(self, bad) -> np.ndarray:
        """Parity-reconstruct the payloads of `bad` on the device."""
        from repro_torch.resilience.parity import reconstruct_blocks
        return reconstruct_blocks(self, bad)

    def _verify_or_recover(self, sel: np.ndarray, rows: torch.Tensor,
                           on_error: str, redecode) -> torch.Tensor:
        """Digest-check decoded `rows`; on mismatch, run the detect →
        recover → degrade loop per `on_error`. `redecode(blocks)` must
        return fresh unverified rows for block ids `blocks`.

        Recovery iterates because corruption is not always where the
        digest fails: in "global" mode a corrupt payload poisons every
        later block of its anchor window (the match chain), so only the
        EARLIEST failing block per window is a reconstruction target each
        pass — healing it and re-decoding clears the later failures (or
        exposes the next true corruption). "ra" blocks are independent, so
        every failing block is a target at once. The loop stops when
        clean, when the bad set stops shrinking (e.g. two corruptions in
        one parity group reconstruct to garbage), or when the archive
        carries no parity. Rows are patched in place (`index_put_`)."""
        sel = np.asarray(sel, np.int64).reshape(-1)
        if sel.size == 0:
            return rows
        got = self._row_digests(sel, rows)
        want = self.archive.block_fnv[sel]
        badpos = np.flatnonzero(got != want)
        if badpos.size == 0:
            return rows
        if on_error == "raise":
            self.check_digests(sel, got)        # raises BlockDigestError
        bad = np.unique(sel[badpos])
        self.last_suspect_blocks = np.union1d(self.last_suspect_blocks, bad)
        for _ in range(int(bad.size)):
            if self.da.mode == "global":
                targets = np.asarray(
                    [int(bad[idx].min()) for _, _, idx
                     in self._anchor_groups(bad)], np.int64)
            else:
                targets = bad
            if self.heal_blocks(targets).size == 0:
                break                           # no parity in the archive
            self._recover["retries"] += 1
            new_rows = redecode(bad)
            ok = (self._row_digests(bad, new_rows)
                  == self.archive.block_fnv[bad])
            fixed = set(bad[ok].tolist())
            self._recover["reconstructed"] += int(
                sum(int(t) in fixed for t in targets))
            if fixed:
                pos_in_bad = {int(b): i for i, b in enumerate(bad)}
                fix_sel = np.asarray(
                    [i for i in badpos if int(sel[i]) in fixed], np.int64)
                src = np.asarray([pos_in_bad[int(sel[i])] for i in fix_sel],
                                 np.int64)
                rows[self._sel_tensor(fix_sel)] = \
                    new_rows[self._sel_tensor(src)]
                badpos = np.asarray(
                    [i for i in badpos if int(sel[i]) not in fixed],
                    np.int64)
            new_bad = bad[~ok]
            if new_bad.size == 0 or new_bad.size >= bad.size:
                bad = new_bad
                break
            bad = new_bad
        if bad.size:
            self._recover["unrecoverable"] += int(bad.size)
            self.last_bad_blocks = np.union1d(self.last_bad_blocks, bad)
            if on_error == "repair":
                why = ("archive carries no parity"
                       if not self.archive.parity_group else
                       "reconstruction re-verify failed (sibling or "
                       "digest-table corruption)")
                raise BlockDigestError(
                    f"blocks {bad.tolist()} unrecoverable: {why}")
            self.quarantined.update(int(b) for b in bad)
            if badpos.size:
                rows[self._sel_tensor(badpos)] = 0
        return rows

    def _run_decode(self, raw, sel, verify: bool, pad_groups: bool,
                    on_error: str) -> torch.Tensor:
        """Shared decode entry: on_error and range checks, the
        fault-injection hook, the quarantine pre-filter, then
        `raw(sel_np, pad_groups)` and the verify/recover tail."""
        check_on_error(on_error)
        sel_np = np.asarray(sel, np.int64).reshape(-1)
        if sel_np.size and (sel_np.min() < 0
                            or sel_np.max() >= self.da.n_blocks):
            raise IndexError(f"block ids outside [0, {self.da.n_blocks})")
        self.last_bad_blocks = np.zeros(0, np.int64)
        self.last_suspect_blocks = np.zeros(0, np.int64)
        self.launch_rounds_last = []
        if self.fault_hook is not None:
            self.fault_hook()
        keep = None
        quar = np.zeros(0, np.int64)
        work = sel_np
        if self.quarantined and sel_np.size:
            qmask = np.isin(sel_np, np.fromiter(self.quarantined, np.int64,
                                                len(self.quarantined)))
            if qmask.any():
                if on_error != "partial":
                    b = int(sel_np[qmask][0])
                    raise BlockDigestError(
                        f"block {b} is quarantined (unrecoverable in an "
                        f"earlier decode); on_error='partial' degrades "
                        f"instead of raising")
                keep = np.flatnonzero(~qmask)
                quar = np.unique(sel_np[qmask])
                work = sel_np[keep]
        if work.size:
            rows = raw(work, pad_groups)
            if verify:
                rows = self._verify_or_recover(
                    work, rows, on_error,
                    lambda b: raw(np.asarray(b, np.int64).reshape(-1),
                                  pad_groups))
        else:
            rows = torch.zeros((0, self.da.block_size), dtype=torch.uint8,
                               device=self.device)
        if keep is not None:
            full = torch.zeros((sel_np.size, self.da.block_size),
                               dtype=torch.uint8, device=self.device)
            if keep.size:
                full[self._sel_tensor(keep)] = rows
            rows = full
            self.last_bad_blocks = np.union1d(self.last_bad_blocks, quar)
        return rows

    def _assemble_ra_groups(self, sel_np: np.ndarray, groups: list,
                            decode_group, pad_groups: bool) -> torch.Tensor:
        """Depth-bucketed "ra" decode: one launch per scheduled-rounds
        group via `decode_group(ids, n_rounds) -> (G, block_size)`,
        reassembled in the selection's original order. `pad_groups`
        pow2-pads each group as the reference does (so
        `decoded_blocks_last` counts the same blocks); streaming passes
        False to keep its exact-size budget."""
        pieces, order, n_mat = [], [], 0
        for rounds, idx in groups:
            gsel = sel_np[idx]
            g = _pad_pow2(gsel) if pad_groups else gsel
            rows = decode_group(g, rounds)
            self.launch_rounds_last.append(rounds)
            n_mat += int(g.size)
            pieces.append(rows[:idx.size])
            order.append(idx)
        order = np.concatenate(order)
        inv = np.empty(order.size, np.int64)
        inv[order] = np.arange(order.size)
        self.decoded_blocks_last = n_mat
        return torch.cat(pieces, dim=0)[self._sel_tensor(inv)]

    def _decode_ra(self, sel_np: np.ndarray, pad_groups: bool,
                   decode_group) -> torch.Tensor:
        groups = self._ra_groups(sel_np)
        if groups is None:
            rows = decode_group(sel_np, self.da.max_depth)
            self.launch_rounds_last.append(self.da.max_depth)
            self.decoded_blocks_last = int(sel_np.size)
            return rows
        return self._assemble_ra_groups(sel_np, groups, decode_group,
                                        pad_groups)

    def decode_blocks(self, sel, verify: bool = False,
                      pad_groups: bool = True,
                      on_error: str = "raise") -> torch.Tensor:
        """Mode 2 decode of block ids `sel` → (B, block_size) u8 rows on
        the device; `verify` digest-checks every row (raising
        `BlockDigestError`)."""
        return self._run_decode(self._decode_blocks_raw, sel, verify,
                                pad_groups, on_error)

    def _decode_blocks_raw(self, sel_np: np.ndarray,
                           pad_groups: bool) -> torch.Tensor:
        if self.da.mode == "global":
            return self._decode_global_rows(sel_np)
        return self._decode_ra(
            sel_np, pad_groups,
            lambda g, r: _decode_sel_core(self.da, self._sel_tensor(g), r))

    def decode_blocks_host_entropy(self, sel, verify: bool = False,
                                   pad_groups: bool = True,
                                   on_error: str = "raise") -> torch.Tensor:
        """Mode 1: host entropy + device match. "ra" selections run the
        LZ77 match kernel on the uploaded streams; global selections decode
        per anchor window ([0, max(sel)] when anchor-free), so every
        cross-block match resolves inside the decoded window."""
        return self._run_decode(self._decode_blocks_host_raw, sel, verify,
                                pad_groups, on_error)

    def _decode_blocks_host_raw(self, sel_np: np.ndarray,
                                pad_groups: bool) -> torch.Tensor:
        if self.da.mode == "global":
            self.decoded_blocks_last = 0
            self.last_window_rows = []
            return self._assemble_groups(
                sel_np, lambda first, last: self._window_rows(
                    first, last, host=True))

        def match_group(g: np.ndarray, n_rounds) -> torch.Tensor:
            gsel = self._sel_tensor(g)
            return ops.lz77_decode_planes(
                **_match_inputs(self.da, self._host_streams(g), gsel),
                n_rounds=n_rounds)

        return self._decode_ra(sel_np, pad_groups, match_group)

    # ---------------------------------------------------- window decode
    def _window_rows(self, first: int, last: int,
                     host: bool = False) -> torch.Tensor:
        """Decode of the contiguous global window [first, last] → (L,
        block_size) u8 rows; `host` decodes its streams on the host (Mode
        1). The flat pointer space is the window, not the archive."""
        L = last - first + 1
        _check_window_bytes(first, last, self.da.block_size)
        streams = (self._host_streams(np.arange(first, last + 1))
                   if host else None)
        n_rounds = self._rounds_for_span(first, last)
        rows = _decode_window_core(self.da, first, last, n_rounds, streams)
        self.launch_rounds_last.append(n_rounds)
        self.decoded_blocks_last += L
        if self.collect_window_rows:
            self.last_window_rows.append((first, rows))
        return rows

    def _anchor_groups(self, sel_np: np.ndarray) -> list:
        from repro_torch.api.plan import anchor_window_groups
        return anchor_window_groups(sel_np, self.da.anchors)

    def _assemble_groups(self, sel_np: np.ndarray,
                         window_rows) -> torch.Tensor:
        """Group a global selection by governing anchor window, decode each
        window via `window_rows(first, last) -> (L, block_size)`, and
        reassemble rows in the selection's original order."""
        groups = self._anchor_groups(sel_np)
        pieces = [window_rows(first, last)[self._sel_tensor(sel_np[idx]
                                                            - first)]
                  for first, last, idx in groups]
        order = np.concatenate([idx for _, _, idx in groups])
        inv = np.empty(order.size, np.int64)
        inv[order] = np.arange(order.size)
        return torch.cat(pieces, dim=0)[self._sel_tensor(inv)]

    def decode_from_anchor(self, first: int, last: int,
                           verify: bool = False) -> torch.Tensor:
        """Global archives: decode blocks [first, last] by materializing
        only the [nearest-anchor(first), last] window instead of the whole
        prefix — the checkpointed-wavefront random-access path. Returns
        (last - first + 1, block_size) u8 rows."""
        if self.da.mode != "global":
            raise ValueError('decode_from_anchor requires mode="global" '
                             '("ra" blocks decode directly)')
        if not 0 <= first <= last < self.da.n_blocks:
            raise IndexError(f"block range [{first}, {last}] outside "
                             f"[0, {self.da.n_blocks})")
        from repro_torch.api.plan import anchor_floor
        win_first = int(anchor_floor(np.asarray([first]),
                                     self.da.anchors)[0])
        self.decoded_blocks_last = 0
        self.launch_rounds_last = []
        self.last_window_rows = []
        out = self._window_rows(win_first, last)[first - win_first:]
        if verify:
            self.verify_rows(np.arange(first, last + 1), out)
        return out

    def _decode_global_rows(self, sel_np: np.ndarray) -> torch.Tensor:
        """Global block selection → (B, block_size) rows via one decode
        per governing anchor window; anchor-free archives decode the whole
        prefix (the reference's one window shape)."""
        self.decoded_blocks_last = 0
        self.launch_rounds_last = []
        self.last_window_rows = []
        if self.da.anchors.size == 0:
            rows = self._window_rows(0, self.da.n_blocks - 1)
            return rows[self._sel_tensor(sel_np)]
        return self._assemble_groups(sel_np, self._window_rows)

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
        """Whole-file decode to host bytes; with `chunk_blocks` set, never
        more than one chunk of decoded output on the device at a time
        (paper §5 v7-RA).

        The reference streams one whole-file `ByteRange` through
        `StreamingExecutor`, whose every chunk is then exactly one
        `chunk_blocks`-block piece decoded with `pad_groups=False` and
        `on_error="raise"`. This loop runs the same block selections with
        the same padding, so the counters equal the reference's, and
        copies each chunk's rows straight into the output instead of
        through the span gather.

        verify=True first checks `file_fnv` over the block digest table,
        then decodes chunk by chunk with every block digest-checked on the
        device (pow2-padded depth buckets, as the reference's verify
        loop). `on_error` picks the failure semantics: "raise"
        (`BlockDigestError` on the first mismatch), "repair" (parity
        reconstruction, raise only if unrecoverable), "partial"
        (unrecoverable blocks quarantine and read back as zeros). A
        corrupt digest TABLE (`file_fnv` fold mismatch) always raises: no
        reference digests means nothing can be trusted or repaired."""
        check_on_error(on_error)
        da = self.da
        out = np.empty(da.raw_size, np.uint8)
        if da.raw_size == 0:
            return out
        if verify:
            a = self.archive
            if file_digest(a.block_fnv) != a.file_fnv:
                raise BlockDigestError(
                    f"file digest mismatch: block digest table folds to "
                    f"{file_digest(a.block_fnv):#018x} != stored "
                    f"{a.file_fnv:#018x}")
        else:
            on_error = "raise"      # as the reference's streamed decode
        decode = (self.decode_blocks if mode2
                  else self.decode_blocks_host_entropy)
        step = int(chunk_blocks or da.n_blocks)
        cols = torch.arange(da.block_size, device=self.device)[None, :]
        pos = 0
        for lo in range(0, da.n_blocks, step):
            sel = np.arange(lo, min(lo + step, da.n_blocks))
            rows = decode(sel, verify=verify, pad_groups=verify,
                          on_error=on_error)
            keep = cols < da.block_len[lo:lo + sel.size].long()[:, None]
            part = rows[keep]                 # rows cropped to block_len
            # one device-to-host copy straight into the output
            torch.from_numpy(out[pos:pos + part.numel()]).copy_(part)
            pos += part.numel()
        return out
