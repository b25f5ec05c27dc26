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

Both steps take the state over: they update its params, moments and
step in place and return it, the counterpart of the reference's donated
jit buffers. A caller that needs the state as it was passes a copy.

The data-parallel step and gradient compression need collectives: they
come with the multi-GPU slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.decoder import _not_in_slice
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)


def init_train_state(model, generator: torch.Generator,
                     opt_cfg: AdamWConfig, dtype=torch.bfloat16) -> Dict:
    params = model.init(generator, dtype)
    return {"params": params, "opt": init_opt_state(params)}


def make_train_step(model, opt_cfg: AdamWConfig,
                    remat: str = "full") -> Callable:
    def step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        keys = list(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
        loss = model.loss(leaves, batch, remat=remat)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
        del leaves
        with torch.no_grad():
            new_p, new_opt, metrics = adamw_update(
                opt_cfg, params, dict(zip(keys, grads)), state["opt"])
        metrics["loss"] = loss.detach()
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


def make_manual_dp_step(*args, **kwargs):
    raise _not_in_slice("make_manual_dp_step (data-parallel collectives)",
                        "multi-GPU")
