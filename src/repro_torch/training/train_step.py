"""Train-step factories: loss → grad → AdamW.

  make_train_step          — one step: forward, backward, AdamW; returns
                             the new state and {"loss", "grad_norm",
                             "lr"} as device scalars (no host sync).
  make_unrolled_train_step — the same step over a (U, B, T) window, a
                             Python loop, with (U,) stacked metrics:
                             bit-identical to U per-step calls. Pairs with
                             `ArchiveDataset.windows(U)`, which decodes the
                             whole window through ONE DecodePlan on the
                             prefetch worker.
  make_manual_dp_step      — data parallelism over the ranks of a
                             `torch.distributed` world: params replicated,
                             each rank's rows of the global batch, loss
                             and gradients averaged by all-reduce —
                             int8-compressed when `compress`
                             (`grad_compress`).

Every step takes the state over: it updates the params, moments and
step in place and returns the state, the counterpart of the reference's donated
jit buffers. A caller that needs the state as it was passes a copy.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.training import grad_compress as gc
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)


def init_train_state(model, generator: torch.Generator,
                     opt_cfg: AdamWConfig, dtype=torch.bfloat16) -> Dict:
    params = model.init(generator, dtype)
    return {"params": params, "opt": init_opt_state(params)}


def _loss_and_grads(model, params: Dict, batch: Dict, remat: str):
    """(loss, {leaf: gradient}) of `model.loss` at `params`."""
    keys = list(params)
    leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
    loss = model.loss(leaves, batch, remat=remat)
    grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
    return loss.detach(), dict(zip(keys, grads))


def make_train_step(model, opt_cfg: AdamWConfig,
                    remat: str = "full") -> Callable:
    def step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        loss, grads = _loss_and_grads(model, state["params"], batch, remat)
        with torch.no_grad():
            new_p, new_opt, metrics = adamw_update(
                opt_cfg, state["params"], grads, state["opt"])
        metrics["loss"] = loss
        return {"params": new_p, "opt": new_opt}, metrics

    return step


def make_unrolled_train_step(model, opt_cfg: AdamWConfig,
                             remat: str = "full") -> Callable:
    """(state, window) → (state, metrics) where `window` stacks U batches
    as {"tokens": (U, B, T), "labels": (U, B, T)} and metrics are stacked
    (U,) per step. The loop body IS `make_train_step`'s step, so the loss
    trajectory is bit-identical to running the steps one call at a time."""
    inner = make_train_step(model, opt_cfg, remat=remat)

    def unrolled(state: Dict, window: Dict) -> Tuple[Dict, Dict]:
        ms = []
        for i in range(window["tokens"].shape[0]):
            state, m = inner(state, {k: v[i] for k, v in window.items()})
            ms.append(m)
        return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return unrolled


def _pmean(t: torch.Tensor, n: int) -> torch.Tensor:
    """Mean of `t` over the world, in place (all-reduce SUM, then / n)."""
    if dist.is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.div_(n)


def make_manual_dp_step(model, opt_cfg: AdamWConfig, mesh,
                        dp_axes=("data",), remat: str = "full",
                        compress: bool = False) -> Callable:
    """Data-parallel step over the ranks of the default process group:
    params replicated on every rank, rank r takes rows [r·B/n,
    (r+1)·B/n) of the global batch (as the reference's `P(dp_axes)`
    splits it), the loss and every gradient are averaged by all-reduce —
    int8-compressed when `compress` (`grad_compress.compress_tree_psum`,
    its noise seeded by the step's `seed`) — then the same AdamW update
    runs on every rank. The mesh's data-parallel entries must equal the
    world (a world of one needs no process group).

    `step(state, batch, seed=0) -> (state, metrics)`."""
    n = int(np.prod([mesh.shape[a] for a in dp_axes]))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(
            f"the mesh has {n} data-parallel entries but the process "
            f"group a world of {world}; build it with make_local_mesh() "
            f"inside the group")
    rank = dist.get_rank() if dist.is_initialized() else 0

    def step(state: Dict, batch: Dict, seed: int = 0) -> Tuple[Dict, Dict]:
        B = batch["tokens"].shape[0]
        if B % n:
            raise ValueError(f"global batch {B} does not split over {n} "
                             f"data-parallel ranks")
        lo, hi = rank * B // n, (rank + 1) * B // n
        local = {k: v[lo:hi] for k, v in batch.items()}
        loss, grads = _loss_and_grads(model, state["params"], local, remat)
        loss = _pmean(loss, n)
        if compress:
            grads = gc.compress_tree_psum(grads, seed)
        else:
            grads = {k: _pmean(g, n) for k, g in grads.items()}
        with torch.no_grad():
            new_p, new_opt, metrics = adamw_update(
                opt_cfg, state["params"], grads, state["opt"])
        metrics["loss"] = loss
        return {"params": new_p, "opt": new_opt}, metrics

    return step
