"""Gradient compression for the data-parallel all-reduce.

int8 stochastic-rounding quantization with a per-tensor scale: each
rank quantizes its gradient against a scale agreed by one all-reduce-max,
the int8 values are summed as int32 over the world (no overflow below
2^23 ranks), and the sum is dequantized to the mean. The data-parallel
step (`train_step.make_manual_dp_step(compress=True)`) reduces through
it.

The noise of the stochastic rounding comes from an explicit
`torch.Generator` on the tensor's device, one a leaf in sorted-key order,
seeded from the step's seed, so every rank draws the same noise. It
cannot reproduce the reference's threefry bits; what holds is the
contract: a dequantized value within one quantum of its input, and no
bias over draws.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Uniform noise in [-0.5, 0.5) on the generator's device."""
    return torch.rand(shape, generator=generator,
                      device=generator.device) - 0.5


def quantize_int8(x: torch.Tensor, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (q int8, scale f32). Stochastic rounding keeps E[dequant] = x."""
    xf = x.to(torch.float32)
    scale = xf.abs().max().clamp_min(1e-12) / 127.0
    y = xf / scale
    q = torch.clamp(torch.round(y + _noise(y.shape, generator)),
                    -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(x: torch.Tensor, generator: torch.Generator
                    ) -> torch.Tensor:
    """Quantized data-parallel mean over the world of the default
    process group (a world of one without one): the scale is agreed by
    an all-reduce MAX, the int8 payload summed as int32, then
    dequantized and divided by the world size."""
    xf = x.to(torch.float32)
    amax = xf.abs().max().clamp_min(1e-12)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if dist.is_initialized():
        dist.all_reduce(amax, op=dist.ReduceOp.MAX)
    scale = amax / 127.0
    y = xf / scale
    q = torch.clamp(torch.round(y + _noise(y.shape, generator)), -127, 127)
    s = q.to(torch.int32)
    if dist.is_initialized():
        dist.all_reduce(s, op=dist.ReduceOp.SUM)
    return (s.to(torch.float32) * scale / n).to(x.dtype)


def leaf_generator(seed: int, i: int, device) -> torch.Generator:
    """The generator of leaf `i` (sorted-key order) at step seed `seed`:
    the same on every rank."""
    state = np.random.SeedSequence((int(seed), int(i))).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def compress_tree_psum(grads: Dict[str, torch.Tensor], seed: int
                       ) -> Dict[str, torch.Tensor]:
    """`compressed_psum` of every leaf, leaves in sorted-key order, each
    with its own generator (`leaf_generator(seed, i, ...)`)."""
    return {k: compressed_psum(grads[k],
                               leaf_generator(seed, i, grads[k].device))
            for i, k in enumerate(sorted(grads))}
