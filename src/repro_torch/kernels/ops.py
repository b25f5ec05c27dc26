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
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.depth import log2_rounds
from repro_torch.core.format import MAX_LANES
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES: Dict[str, int] = {"rans_decode": 0, "lz77_match": 0}

# dynamic shared memory the match kernel may take for its two ping-pong
# pointer arrays (Hopper allows 227 KB per block; the rest is headroom
# for the scan's static storage)
LZ77_SMEM_LIMIT = 200 * 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "rans_decode_launch": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _P, _I, _P],
    "lz77_decode_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P, _I, _P],
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


# -------------------------------------------------------------- LZ77 match
def lz77_decode_blocks(lit_lens, match_lens, offsets, n_cmds, literals,
                       block_len, out_size: int,
                       n_rounds: Optional[int] = None) -> torch.Tensor:
    """(B, C) i32 command planes + (B, L) u8 literals → (B, out_size) u8.

    `n_rounds` is the resolve-round count of this launch (the archive's
    recorded chain depth or a depth bucket's). None = depth unknown: the
    decode stops once no pointer moves, at most ceil(log2(out_size))
    rounds."""
    if not _on_cuda(lit_lens, "lz77_match"):
        return _ref.lz77_decode_blocks_ref(
            lit_lens, match_lens, offsets, n_cmds, literals, block_len,
            out_size, n_rounds=n_rounds)
    dev = lit_lens.device
    B, C = lit_lens.shape
    L = literals.shape[1]
    for name, t in (("lit_lens", lit_lens), ("match_lens", match_lens),
                    ("offsets", offsets)):
        _check(name, t, torch.int32, (B, C), dev)
    _check("n_cmds", n_cmds, torch.int32, (B,), dev)
    _check("block_len", block_len, torch.int32, (B,), dev)
    _check("literals", literals, torch.uint8, (B, L), dev)
    if C < 1 or L < 1 or out_size < 1:
        raise ValueError(f"lz77_match: empty geometry C={C} L={L} "
                         f"out_size={out_size}")
    out = torch.empty((B, out_size), dtype=torch.uint8, device=dev)
    if B == 0:
        return out
    use_smem = 2 * out_size * 4 <= LZ77_SMEM_LIMIT
    cmd_scratch = torch.empty((B, 2, C), dtype=torch.int32, device=dev)
    ptr_scratch = (torch.empty(0, dtype=torch.int32, device=dev) if use_smem
                   else torch.empty((B, 2, out_size), dtype=torch.int32,
                                    device=dev))
    rounds = log2_rounds(out_size) if n_rounds is None else int(n_rounds)
    err = _fn("lz77_match", "lz77_decode_launch")(
        lit_lens.data_ptr(), match_lens.data_ptr(), offsets.data_ptr(),
        n_cmds.data_ptr(), literals.data_ptr(), block_len.data_ptr(),
        B, C, L, out_size, rounds, int(use_smem), cmd_scratch.data_ptr(),
        ptr_scratch.data_ptr(), out.data_ptr(), dev.index or 0,
        _stream(dev))
    _raise_on(err, "lz77_match", "lz77_decode_error_string")
    LAUNCHES["lz77_match"] += 1
    return out


# ------------------------------------------------------------- rANS decode
def rans_decode(words, word_off, n_syms, lanes, class_ids, tables,
                t_max: int, k_max: int = MAX_LANES, group: int = 8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (rows (S, max(t_max, 1) * k_max) u8 step-major, T per-stream
    steps). `words` is the u16 word buffer as i16 bits, `word_off` i64,
    `tables` the archive's `ref.rans_tables`. `group` is the number of
    streams (warps) per CTA."""
    if not _on_cuda(words, "rans_decode"):
        return _ref.rans_decode_ref(words, word_off, n_syms, lanes,
                                    class_ids, tables, t_max, k_max=k_max)
    dev = words.device
    S = word_off.shape[0]
    W = words.shape[0]
    if k_max != 32:
        raise ValueError(f"rans_decode: the kernel maps rANS lanes onto the "
                         f"32 CUDA lanes of a warp; k_max={k_max}")
    if not 1 <= group <= 32:
        raise ValueError(f"rans_decode: group={group} outside [1, 32]")
    if W < 2:
        raise ValueError("rans_decode: word buffer holds no stream")
    freq, cum, sym = tables
    _check("words", words, torch.int16, (W,), dev)
    _check("word_off", word_off, torch.int64, (S,), dev)
    for name, t in (("n_syms", n_syms), ("lanes", lanes),
                    ("class_ids", class_ids)):
        _check(name, t, torch.int32, (S,), dev)
    _check("freq", freq, torch.int16, (4, 256), dev)
    _check("cum", cum, torch.int16, (4, 256), dev)
    _check("sym", sym, torch.uint8, (4, 4096), dev)
    if sym.data_ptr() % 16:
        raise ValueError("rans_decode: sym table must be 16-byte aligned")
    steps = max(int(t_max), 1)
    out = torch.empty((S, steps * k_max), dtype=torch.uint8, device=dev)
    n = n_syms.to(torch.int64)
    K = lanes.to(torch.int64).clamp(min=1)
    T = torch.where(n > 0, -(-n // K), 0).to(torch.int32)
    if S == 0:
        return out, T
    err = _fn("rans_decode", "rans_decode_launch")(
        words.data_ptr(), W, word_off.data_ptr(), n_syms.data_ptr(),
        lanes.data_ptr(), class_ids.data_ptr(), freq.data_ptr(),
        cum.data_ptr(), sym.data_ptr(), S, int(t_max), group,
        out.data_ptr(), dev.index or 0, _stream(dev))
    _raise_on(err, "rans_decode", "rans_decode_error_string")
    LAUNCHES["rans_decode"] += 1
    return out, T
