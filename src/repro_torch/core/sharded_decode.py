"""Block-parallel decode over a device mesh (the reference's fan-out of
the single-card pipeline over a TPU mesh, on PyTorch devices).

Two residency regimes, chosen by archive size:

  ``replicate_archive``   — the compressed archive is REPLICATED on every
      mesh device and only the decode *work* (the block selection)
      shards over the mesh axes. The small-archive path: no placement
      math, and absolute offsets make every block's work independent.

  ``partition_archive``   — blocks partition into CONTIGUOUS per-shard
      ranges and each shard holds only its slice of the compressed
      payload: one `DeviceArchive` per shard, on that shard's device,
      padded to the common (nb_max, w_max) geometry. Per-shard word
      offsets are REBASED to the shard's own words slice (i32, as the
      reference stores them), so a shard's resident bytes are the
      reference's count of its slice of the stacked arrays: per device,
      about total_compressed / n_shards + one shard's padding slack.

Every shard decodes with the same `_decode_sel_core` as every other
path, so each shard's decode is one launch of each CUDA kernel per depth
bucket. A selection lowers to one (n_shards, S) local-id matrix, each
shard decodes its own S rows on its own device (a shard that owns none
of the selection decodes nothing), and assembly moves only the requested
rows to the caller's device — never whole shards.

The reference runs one `shard_map` launch over the mesh; the port runs
one decode per shard. Its counters are kept as the reference keeps them
(one `launch_rounds_last` entry and a per-shard width S of
`decoded_blocks_last` per stacked decode); `ops.LAUNCHES` counts the real
kernel launches, n_shards times as many.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.plan import shard_selection, split_shards
from repro_torch.core.decoder import (Decoder, DeviceArchive,
                                      _decode_sel_core, _fnv_rows_core)
from repro_torch.kernels.ref import rans_tables
from repro_torch.launch.mesh import Mesh, shard_devices


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _rounds(dec: Decoder, n_rounds: Optional[int]) -> Optional[int]:
    """The reference's round argument: -1 = the archive-wide bound."""
    return dec.da.max_depth if n_rounds == -1 else n_rounds


def _ids(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.int64)).to(device)


# ------------------------------------------------------- replicated fan-out
def _replica(dec: Decoder, device: torch.device) -> DeviceArchive:
    """The decoder's archive on `device`: its own `da` there, else a copy
    made once (`replicate_archive`) and kept in `dec.replicas`."""
    if device == dec.device:
        return dec.da
    da = dec.replicas.get(device)
    if da is None:
        da = dataclasses.replace(
            dec.da, **{f: getattr(dec.da, f).to(device) for f in
                       ("words", "word_off", "n_syms", "lanes", "n_cmds",
                        "block_start", "block_len")},
            tables=tuple(t.to(device) for t in dec.da.tables))
        dec.replicas[device] = da
    return da


def replicate_archive(dec: Decoder, mesh: Mesh) -> None:
    """Put the archive's device tensors on every mesh device (one copy a
    distinct device; the decoder's own device keeps `dec.da`)."""
    for dev in set(mesh.devices.flat):
        _replica(dec, dev)


def sharded_decode_blocks(dec: Decoder, sel: Sequence[int], mesh: Mesh,
                          axes: Tuple[str, ...] = ("data",),
                          n_rounds: int = -1) -> torch.Tensor:
    """Decode `sel` blocks with the work sharded over `axes` of `mesh`
    (replicated-archive regime) → (len(sel), block_size) u8 on the
    decoder's device.

    `sel` is padded to n_shards * pow2(ceil(n / n_shards)), as the
    reference pads it; each shard decodes its contiguous share on its
    device. `n_rounds` bounds the resolve rounds of this decode (-1 = the
    archive-wide `max_depth`); `ShardedExecutor` passes each depth
    bucket's schedule so shallow shards stop early."""
    if dec.da.mode == "global":
        # a shard's selection is an arbitrary block subset, but a global
        # (wavefront) decode resolves matches through a contiguous window
        raise NotImplementedError(
            'sharded decode supports "ra" archives only; global/wavefront '
            "selections decode through contiguous (anchor) windows — use "
            "DeviceExecutor/StreamingExecutor for global archives")
    devs = shard_devices(mesh, axes)
    n_shards = len(devs)
    sel = np.asarray(sel, np.int64).reshape(-1)
    n = sel.size
    cap = n_shards * _pow2(-(-max(n, 1) // n_shards))
    if cap != n:
        sel = np.concatenate([sel, np.repeat(sel[-1:] if n else
                                             np.zeros(1, np.int64),
                                             cap - n)])
    rounds = _rounds(dec, n_rounds)
    dec.launch_rounds_last.append(rounds)
    per = cap // n_shards
    parts = [_decode_sel_core(_replica(dec, dev),
                              _ids(sel[s * per:(s + 1) * per], dev),
                              rounds).to(dec.device)
             for s, dev in enumerate(devs)]
    return torch.cat(parts)[:n]


# ------------------------------------------------------- partitioned regime
@dataclasses.dataclass
class ShardPartition:
    """A mesh-partitioned compressed archive: contiguous per-shard block
    ranges, one `DeviceArchive` per shard on its device (padded to the
    common geometry, word offsets rebased shard-locally)."""
    mesh: Mesh
    axes: Tuple[str, ...]
    n_shards: int
    bounds: np.ndarray          # i64[n_shards + 1] block partition bounds
    w_lo: np.ndarray            # i64[n_shards] each shard's first word
    shards: List[DeviceArchive]
    nb_max: int                 # per-shard table rows (padded)
    w_max: int                  # per-shard words (padded)
    block_size: int
    n_blocks: int

    def shard_of(self, blocks: np.ndarray) -> np.ndarray:
        """Owning shard per global block id."""
        return split_shards(blocks, self.bounds)[0]

    def local_ids(self, blocks: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Global block ids → (owning shard, shard-local id)."""
        return split_shards(blocks, self.bounds)

    def global_ids(self, loc: np.ndarray) -> np.ndarray:
        """(n_shards, S) local-id matrix → global block ids."""
        return self.bounds[:-1, None] + np.asarray(loc, np.int64)

    @property
    def devices(self) -> list:
        return [sh.device for sh in self.shards]

    @property
    def per_shard_device_bytes(self) -> int:
        """Compressed bytes resident on ONE shard: its padded slice of
        every payload plane (every shard pads to the same geometry)."""
        return self.shards[0].device_bytes

    def shard_blocks(self) -> np.ndarray:
        return np.diff(self.bounds)

    def reseed(self, archive) -> None:
        """Copy every shard's slice of `archive` (the host copy, healed)
        into the shard's tensors in place: the geometry is unchanged, so
        the tensors, and whatever holds this partition, stay valid."""
        for s, sh in enumerate(self.shards):
            host = _shard_host(archive, self, s)
            for f, x in host.items():
                getattr(sh, f).copy_(torch.from_numpy(x))


def _shard_host(a, part: ShardPartition, s: int) -> dict:
    """Shard `s`'s padded host slices of the payload planes, keyed by
    `DeviceArchive` field (words as their i16 bits, offsets rebased)."""
    nb, W = part.nb_max, part.w_max
    b0, b1 = int(part.bounds[s]), int(part.bounds[s + 1])
    lo = int(part.w_lo[s])
    hi = (int(a.words.size) if b1 == part.n_blocks
          else int(np.asarray(a.word_off[b1], np.int64).min()))
    words = np.zeros(W, np.uint16)
    words[:hi - lo] = a.words[lo:hi]

    def rows(x, dtype, cols=()):
        out = np.zeros((nb, *cols), dtype)
        out[:b1 - b0] = x[b0:b1]
        return out

    return {"words": words.view(np.int16),
            # the rebase: shard-local offsets into the shard's own slice
            "word_off": rows(np.asarray(a.word_off, np.int64) - lo,
                             np.int32, (4,)),
            "n_syms": rows(a.n_syms, np.int32, (4,)),
            "lanes": rows(a.lanes, np.int32, (4,)),
            "n_cmds": rows(a.n_cmds, np.int32),
            # low 32 bits, as `to_device` keeps them
            "block_start": rows(np.asarray(a.block_start,
                                           np.int64).astype(np.int32),
                                np.int32),
            "block_len": rows(a.block_len, np.int32)}


def partition_archive(dec: Decoder, mesh: Mesh,
                      axes: Tuple[str, ...] = ("data",)) -> ShardPartition:
    """Partition a mode-"ra" archive's compressed planes across the mesh.

    Bounds balance the per-shard WORD footprint (blocks compress
    unevenly; splitting by block count could leave one shard holding most
    of the payload). Each shard's tables are sliced to its block range,
    padded to the common (nb_max, w_max) geometry, and the word offsets
    are rebased by the shard's first word — shard-local offsets into the
    shard's own words slice, which must stay below 2^31 (the reference
    stores them as i32, and the port rejects the same archives)."""
    if dec.da.mode != "ra":
        raise NotImplementedError(
            'partition_archive supports "ra" archives only; global/'
            "wavefront decode windows cross block bounds — use "
            "replicate_archive")
    devs = shard_devices(mesh, axes)
    n_shards = len(devs)
    a = dec.archive
    n_blocks = int(a.n_blocks)
    if n_blocks < n_shards:
        raise ValueError(
            f"{n_blocks} blocks cannot partition over {n_shards} shards — "
            f"use replicate_archive for sub-mesh archives")
    # block b's words live in [w_start[b], w_start[b+1]): the encoder lays
    # streams out block-major; the min over the 4 stream columns is the
    # block's first word whatever the column order
    w_start = np.asarray(a.word_off, np.int64).min(axis=1)
    if np.any(np.diff(w_start) < 0) or (n_blocks and w_start[0] != 0):
        raise NotImplementedError(
            "archive words are not block-contiguous; cannot slice "
            "per-shard payloads — use replicate_archive")
    w_end = np.concatenate([w_start[1:], [np.int64(a.words.size)]])

    # balanced bounds: cut at the blocks nearest the equal-words targets,
    # then force strict monotonicity (every shard owns >= 1 block)
    total_words = int(a.words.size)
    targets = (np.arange(1, n_shards) * total_words) // n_shards
    inner = np.searchsorted(w_start, targets, side="left")
    bounds = np.zeros(n_shards + 1, np.int64)
    bounds[-1] = n_blocks
    for i in range(1, n_shards):
        lo = bounds[i - 1] + 1
        hi = n_blocks - (n_shards - i)
        bounds[i] = min(max(int(inner[i - 1]), lo), hi)

    nb_max = int(np.diff(bounds).max())
    w_lo = w_start[bounds[:-1]]
    w_hi = w_end[bounds[1:] - 1]
    w_max = int((w_hi - w_lo).max())
    if w_max >= 2**31:
        raise ValueError(
            f"one shard would hold {w_max} words >= 2^31 — rebased "
            f"word offsets must stay int32; widen the mesh")

    part = ShardPartition(mesh=mesh, axes=tuple(axes), n_shards=n_shards,
                          bounds=bounds, w_lo=w_lo, shards=[],
                          nb_max=nb_max, w_max=w_max,
                          block_size=dec.da.block_size, n_blocks=n_blocks)
    tables = {dec.device: dec.da.tables}
    for s, dev in enumerate(devs):
        if dev not in tables:
            tables[dev] = rans_tables(a.freqs, dev)
        # one shard's host slices at a time: a large archive's words are
        # copied once, not stacked on the host first
        up = {f: torch.from_numpy(x).to(dev)
              for f, x in _shard_host(a, part, s).items()}
        b0, b1 = int(bounds[s]), int(bounds[s + 1])
        part.shards.append(DeviceArchive(
            **up, tables=tables[dev], block_size=dec.da.block_size,
            n_blocks=nb_max, raw_size=int(a.block_len[b0:b1].sum()),
            mode="ra", entropy=dec.da.entropy, max_cmds=dec.da.max_cmds,
            offset_bytes=dec.da.offset_bytes, max_depth=dec.da.max_depth))
    return part


def partitioned_rows(dec: Decoder, part: ShardPartition, loc: np.ndarray,
                     n_rounds: int = -1,
                     valid: Optional[np.ndarray] = None
                     ) -> List[Optional[torch.Tensor]]:
    """(n_shards, S) shard-local block ids → n_shards (S, block_size) u8
    row tensors, shard s's on its device: one decode a shard. The
    low-level entry: callers own the loc-matrix construction (and its
    padding semantics — pad slots decode the shard's block 0 and must not
    be read when the decode runs fewer rounds than that block needs).
    With `valid`, a shard with no valid slot decodes nothing and reads
    None: its row of the reference's stacked launch is all padding."""
    rounds = _rounds(dec, n_rounds)
    return [None if valid is not None and not valid[s].any() else
            _decode_sel_core(sh, _ids(loc[s], sh.device), rounds)
            for s, sh in enumerate(part.shards)]


def verify_stacked(dec: Decoder, part: ShardPartition,
                   stacked: List[Optional[torch.Tensor]], loc: np.ndarray,
                   valid: Optional[np.ndarray] = None) -> None:
    """Shard-local digest check of a per-shard decode, BEFORE assembly:
    every row's 8-byte-stride FNV-1a-64 on its shard's device (the shards
    of one device in one pass), compared against the archive table at
    the true global block ids. `valid` masks pad slots (their rows may be
    garbage when the decode ran a shallow bucket's rounds; a shard of
    pad slots only decoded nothing). Raises `BlockDigestError` naming the
    true block id."""
    S = loc.shape[1]
    gids = part.global_ids(loc).reshape(-1)
    blen = np.asarray(dec.archive.block_len, np.int32)[gids]
    got = np.zeros(gids.size, np.uint64)
    by_dev: dict = {}
    for s, rows in enumerate(stacked):
        if rows is not None:
            by_dev.setdefault(rows.device, []).append(s)
    for dev, ss in by_dev.items():
        pos = np.concatenate([np.arange(s * S, (s + 1) * S) for s in ss])
        rows = torch.cat([stacked[s] for s in ss])
        hi, lo = _fnv_rows_core(rows, torch.from_numpy(blen[pos]).to(dev))
        got[pos] = ((hi.cpu().numpy().astype(np.uint64) << np.uint64(32))
                    | lo.cpu().numpy().astype(np.uint64))
    if valid is not None:
        keep = np.asarray(valid, bool).reshape(-1)
        gids, got = gids[keep], got[keep]
    dec.check_digests(gids, got)


def assemble_rows(stacked: List[Optional[torch.Tensor]],
                  flat_idx: np.ndarray, S: int, device) -> torch.Tensor:
    """The rows at `flat_idx` of the flattened shard-major (n_shards * S)
    decode output, in that order, on `device`: each shard's requested
    rows move once."""
    bs = next(r for r in stacked if r is not None).shape[1]
    out = torch.empty((flat_idx.size, bs), dtype=torch.uint8, device=device)
    shard, col = np.divmod(np.asarray(flat_idx, np.int64), S)
    for s in np.unique(shard):
        pos = np.flatnonzero(shard == s)
        rows = stacked[s].index_select(0, _ids(col[pos], stacked[s].device))
        out.index_copy_(0, _ids(pos, device), rows.to(device))
    return out


def partitioned_decode_blocks(dec: Decoder, part: ShardPartition,
                              sel: Sequence[int], n_rounds: int = -1,
                              verify: bool = False,
                              pad: bool = True) -> torch.Tensor:
    """Decode an arbitrary block selection against a partitioned archive:
    (len(sel), block_size) u8 rows in selection order, on the decoder's
    device.

    The selection splits per owning shard into one (n_shards, S) local-id
    matrix (S pow2-padded unless `pad=False` — the streaming budget path
    keeps exact sizes); each shard decodes only its own rows, and only
    the requested rows are assembled. Appends this decode's round count
    to `dec.launch_rounds_last` and adds the PER-SHARD materialized row
    count S to `dec.decoded_blocks_last` (per-shard residency is the
    quantity budgets bound in this regime)."""
    sel = np.asarray(sel, np.int64).reshape(-1)
    if sel.size == 0:
        return torch.zeros((0, part.block_size), dtype=torch.uint8,
                           device=dec.device)
    shard, local = part.local_ids(sel)
    loc, flat_idx, valid = shard_selection(shard, local, part.n_shards,
                                           pad=pad)
    stacked = partitioned_rows(dec, part, loc, n_rounds=n_rounds,
                               valid=valid)
    dec.launch_rounds_last.append(_rounds(dec, n_rounds))
    dec.decoded_blocks_last += int(loc.shape[1])
    if verify:
        verify_stacked(dec, part, stacked, loc, valid=valid)
    return assemble_rows(stacked, flat_idx, loc.shape[1], dec.device)
