"""Kernel wrappers, dispatched by the device of their tensors.

A CPU tensor goes to the plain PyTorch version in `kernels.ref`; a CUDA
tensor goes to the hand-written Hopper kernel in `csrc/` or the call
raises. There is no fallback from a kernel to its plain version.

`LAUNCHES` counts, per kernel, the launches the wrappers made in this
process (one per launch, nowhere else) — the instrumentation that shows
a decode went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.core.depth import log2_rounds
from repro_torch.core.format import N_STREAMS, PROB_SCALE
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES: Dict[str, int] = {"rans_decode": 0, "lz77_match": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "rans_decode_launch": [_P, _LL, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I,
                           _P],
    "lz77_match_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I,
                          _P],
    "lz77_match_scratch": [_I, _I, _P],
    "lz77_match_occupancy": [_I, _I, _I, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(t: torch.Tensor, kernel: str) -> bool:
    """True for CUDA tensors, False for CPU ones; anything else raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {t.device}")
    return True


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} tensor on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def _check_rows(name: str, t: torch.Tensor, rows: int,
                device: torch.device) -> None:
    """A (rows, w >= 1) u8 tensor whose rows are contiguous (a column view
    of a wider tensor is fine)."""
    if (t.dtype != torch.uint8 or t.device != device or t.dim() != 2
            or t.shape[0] != rows or t.shape[1] < 1 or t.stride(1) != 1):
        raise ValueError(
            f"{name}: need ({rows}, w >= 1) uint8 rows on {device} with "
            f"contiguous columns, got {t.dtype} {tuple(t.shape)} strides "
            f"{t.stride()} on {t.device}")


def _fn(kernel: str, symbol: str):
    fn = getattr(_build.library(kernel), symbol)
    fn.argtypes = _SIGNATURES[symbol]
    fn.restype = _I
    return fn


def _raise_on(err: int, kernel: str, symbol: str) -> None:
    if err:
        msg = getattr(_build.library(kernel), symbol)
        msg.argtypes, msg.restype = [_I], ctypes.c_char_p
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} "
                           f"({msg(err).decode()})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ints(ctype, values):
    return (ctype * len(values))(*values)


# -------------------------------------------------------------- LZ77 match
def lz77_decode_planes(literals, lengths, offsets, commands, n_cmds,
                       block_len, out_size: int, max_cmds: int,
                       offset_bytes: int,
                       n_rounds: Optional[int] = None) -> torch.Tensor:
    """Decoded stream bytes of B self-contained blocks → (B, out_size) u8.

    `literals` (B, L) and the byte planes `lengths` (match lengths),
    `offsets` and `commands` (literal lengths) are (B, w) u8 rows, column
    views of `rans_decode_streams`' output or separate tensors; `max_cmds`
    is the command slots per block, `offset_bytes` the offset planes
    stored. `n_rounds` is the resolve-round count of this launch (the
    archive's recorded chain depth or a depth bucket's). None = depth
    unknown: the decode stops once no pointer moves, at most
    ceil(log2(out_size)) rounds."""
    if not _on_cuda(literals, "lz77_match"):
        return _ref.lz77_decode_planes_ref(
            literals, lengths, offsets, commands, n_cmds, block_len,
            out_size, max_cmds, offset_bytes, n_rounds=n_rounds)
    dev = literals.device
    B = literals.shape[0]
    planes = (literals, lengths, offsets, commands)
    for name, t in zip(("literals", "lengths", "offsets", "commands"),
                       planes):
        _check_rows(name, t, B, dev)
    _check("n_cmds", n_cmds, torch.int32, (B,), dev)
    _check("block_len", block_len, torch.int32, (B,), dev)
    if max_cmds < 1 or out_size < 1 or offset_bytes < 1:
        raise ValueError(f"lz77_match: empty geometry max_cmds={max_cmds} "
                         f"out_size={out_size} offset_bytes={offset_bytes}")
    out = torch.empty((B, out_size), dtype=torch.uint8, device=dev)
    if B == 0:
        return out
    per_block = ctypes.c_longlong()
    _fn("lz77_match", "lz77_match_scratch")(out_size, max_cmds,
                                            ctypes.byref(per_block))
    scratch = torch.empty(B * per_block.value, dtype=torch.uint8, device=dev)
    rounds = log2_rounds(out_size) if n_rounds is None else int(n_rounds)
    err = _fn("lz77_match", "lz77_match_launch")(
        _ints(_P, [t.data_ptr() for t in planes]),
        _ints(_LL, [t.stride(0) for t in planes]),
        _ints(_I, [t.shape[1] for t in planes]),
        n_cmds.data_ptr(), block_len.data_ptr(), B, max_cmds, out_size,
        int(offset_bytes), max(rounds, 0), scratch.data_ptr(), out.data_ptr(),
        dev.index or 0, _stream(dev))
    _raise_on(err, "lz77_match", "lz77_match_error_string")
    LAUNCHES["lz77_match"] += 1
    return out


def lz77_occupancy(out_size: int, max_cmds: int,
                   device=None) -> Dict[str, int]:
    """The match kernel's launch configuration at one block geometry and
    the CTAs of it that fit on one SM (`cudaOccupancyMaxActiveBlocks...`)."""
    dev = torch.device(device or "cuda")
    info = (ctypes.c_int * 5)()
    err = _fn("lz77_match", "lz77_match_occupancy")(
        out_size, max_cmds, dev.index or 0, info)
    _raise_on(err, "lz77_match", "lz77_match_error_string")
    keys = ("ctas_per_sm", "threads", "smem_bytes", "pointer_bytes",
            "in_smem")
    return dict(zip(keys, info))


# ------------------------------------------------------------- rANS decode
def rans_decode_streams(words, word_off, n_syms, lanes, tables,
                        layout: _ref.StreamLayout,
                        group: int = 8) -> torch.Tensor:
    """rANS decode of the 4 streams of each of B blocks → (B, layout.row)
    u8 linear stream rows (see `ref.rans_decode_streams_ref`). `words` is
    the u16 word buffer as i16 bits; `word_off` (B, 4) i64, `n_syms` and
    `lanes` (B, 4) i32 are the blocks' stream tables (class = column);
    `tables` the archive's `ref.rans_tables`. `group` is the number of
    blocks (one warp each) per CTA."""
    if not _on_cuda(words, "rans_decode"):
        return _ref.rans_decode_streams_ref(words, word_off, n_syms, lanes,
                                            tables, layout)
    dev = words.device
    B = word_off.shape[0]
    W = words.shape[0]
    if not 1 <= group <= 16:
        raise ValueError(f"rans_decode: group={group} outside [1, 16]")
    if W < 2:
        raise ValueError("rans_decode: word buffer holds no stream")
    if layout.row % 16 or any(
            layout.starts[c] + layout.widths[c] > layout.starts[c + 1]
            for c in range(N_STREAMS)):
        raise ValueError(f"rans_decode: segments overlap or the row is not "
                         f"16-byte aligned: {layout}")
    slots = tables[3]
    _check("words", words, torch.int16, (W,), dev)
    _check("word_off", word_off, torch.int64, (B, N_STREAMS), dev)
    for name, t in (("n_syms", n_syms), ("lanes", lanes)):
        _check(name, t, torch.int32, (B, N_STREAMS), dev)
    _check("slots", slots, torch.int32, (N_STREAMS, PROB_SCALE), dev)
    if slots.data_ptr() % 16:
        raise ValueError("rans_decode: slot table must be 16-byte aligned")
    out = torch.empty((B, layout.row), dtype=torch.uint8, device=dev)
    if B == 0:
        return out
    err = _fn("rans_decode", "rans_decode_launch")(
        words.data_ptr(), W, word_off.data_ptr(), n_syms.data_ptr(),
        lanes.data_ptr(), slots.data_ptr(), B, group,
        _ints(_I, layout.starts), _ints(_I, layout.widths), out.data_ptr(),
        dev.index or 0, _stream(dev))
    _raise_on(err, "rans_decode", "rans_decode_error_string")
    LAUNCHES["rans_decode"] += 1
    return out
