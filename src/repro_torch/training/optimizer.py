"""Hand-rolled AdamW over flat param dicts (the reference's optimizer).

Moments live in fp32 whatever the param dtype (bf16 params + fp32 m/v:
2 + 4 + 4 = 10 B a parameter). Global-norm clipping, decoupled weight
decay (skipped for 1-D and `norm` params), linear-warmup cosine schedule.
`step` is an int32 scalar tensor on the params' device, and every
schedule term is computed there, so an update makes no host sync.

`adamw_update` writes the new params, moments and step into the tensors
it is given and returns those same tensors: the caller hands its state
over, as the reference donates the state to its jitted step. A caller
that needs the old state passes copies.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(params: Dict) -> Dict:
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
              for k, v in params.items()},
        "v": {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
              for k, v in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: Dict) -> torch.Tensor:
    """sqrt of the summed squares of every leaf, in fp32 (leaves in
    sorted-key order, as `jax.tree.leaves` walks a dict)."""
    return torch.sqrt(sum(torch.sum(tree[k].to(torch.float32) ** 2)
                          for k in sorted(tree)))


def adamw_update(cfg: AdamWConfig, params: Dict, grads: Dict,
                 opt: Dict) -> Tuple[Dict, Dict, Dict]:
    step = opt["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    for k, p in params.items():
        g = grads[k].to(torch.float32) * scale
        m = b1 * opt["m"][k] + (1 - b1) * g
        v = b2 * opt["v"][k] + (1 - b2) * g * g
        del g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        decay = 0.0 if p.dim() <= 1 or "norm" in k else cfg.weight_decay
        pf = p.to(torch.float32)
        pf = pf - lr * (upd + decay * pf)
        del upd
        opt["m"][k].copy_(m)
        opt["v"][k].copy_(v)
        p.copy_(pf)
    opt["step"].copy_(step)
    return params, opt, {"grad_norm": gn, "lr": lr}
