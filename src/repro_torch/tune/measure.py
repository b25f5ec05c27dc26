"""Measurement primitives of the autotuner.

`time_fn` is a best-of-N wall-clock timer. The port's decodes return
device tensors before the device has finished, so every call is
followed by a synchronization of the result's CUDA device (nothing on
the CPU): the timer measures the decode, not its launch.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch


def _wait(out) -> None:
    """Block until the device work behind the tensor `out` has finished."""
    if isinstance(out, torch.Tensor) and out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 3,
            **kw) -> float:
    """Best-of-N wall time in seconds (after warmup), waiting for the
    device after every call."""
    for _ in range(warmup):
        _wait(fn(*args, **kw))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        _wait(fn(*args, **kw))
        best = min(best, time.perf_counter() - t0)
    return best


def measure_point(archive, decoder, sample_bytes: int, iters: int = 3
                  ) -> dict:
    """Ratio / seek-latency / decode-throughput of one encoded sample.

    Returns the three objective axes the Pareto frontier is computed
    over: `ratio` (raw/compressed, higher better), `seek_us` (one-block
    random access at the archive's midpoint, lower better), and
    `decode_GBps` (whole-sample selection decode, higher better).
    """
    n_blocks = archive.n_blocks
    sel_all = np.arange(n_blocks)
    t_full = time_fn(lambda: decoder.decode_blocks(sel_all), iters=iters)
    one = np.array([n_blocks // 2])
    t_seek = time_fn(lambda: decoder.decode_blocks(one), iters=iters)
    return {
        "ratio": float(archive.ratio),
        "seek_us": t_seek * 1e6,
        "decode_GBps": sample_bytes / max(t_full, 1e-12) / 1e9,
    }
