"""Carry state across packages: numpy arrays ↔ the port's tensors.

`state_from_numpy` turns the reference's parameters (and optionally its
AdamW state) given as numpy arrays into the port's train state on
`device`. A bfloat16 array is recognised by `arr.dtype.name` and read
through its raw 16-bit words, so `ml_dtypes` is never imported.
`state_to_numpy` is the inverse; bf16 tensors come back as their raw
uint16 words unless a numpy `bfloat16` dtype is passed to view them as.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

_NP_TO_TORCH = {"float32": torch.float32, "float64": torch.float64,
                "float16": torch.float16, "int32": torch.int32,
                "int64": torch.int64, "int16": torch.int16,
                "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}
TORCH_TO_NP[torch.bfloat16] = "bfloat16"


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    """One numpy array (bfloat16 included) → a tensor on `device`."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def tensor_to_numpy(t: torch.Tensor, bfloat16=None) -> np.ndarray:
    """One tensor → a host numpy array; bf16 as raw uint16 words, or
    viewed as the numpy dtype `bfloat16` when one is given."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).cpu().numpy().view(np.uint16)
        return bits.view(bfloat16) if bfloat16 is not None else bits
    return t.cpu().numpy()


def state_from_numpy(params: Dict[str, np.ndarray], device="cuda",
                     opt: Optional[Dict] = None) -> Dict:
    """The reference's flat params {path: array} (and its optimizer state
    {"m": {...}, "v": {...}, "step": scalar}) → the port's train state
    {"params", "opt"}. Without `opt`, fresh AdamW state."""
    from repro_torch.training.optimizer import init_opt_state
    p = {k: tensor_from_numpy(v, device) for k, v in params.items()}
    if opt is None:
        return {"params": p, "opt": init_opt_state(p)}
    o = {"m": {k: tensor_from_numpy(v, device) for k, v in opt["m"].items()},
         "v": {k: tensor_from_numpy(v, device) for k, v in opt["v"].items()},
         "step": tensor_from_numpy(np.asarray(opt["step"], np.int32),
                                   device)}
    return {"params": p, "opt": o}


def state_to_numpy(tree, bfloat16=None):
    """Inverse of `state_from_numpy` over any nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v, bfloat16) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tensor_to_numpy(tree, bfloat16)
    return np.asarray(tree)
