"""Fault-tolerant checkpointing with ACEAPEX-compressed payloads.

The paper's codec as the checkpoint transport: every tensor is serialized,
concatenated, encoded as an "ra" archive (self-contained 16 KB blocks),
and on restore decoded block-parallel on the chosen device — on the card
that is a whole-file `Decoder.decode_all`, which runs both decode
kernels. Durability: write-to-temp + atomic rename, a manifest with FNV
digests, keep-last-k.

The on-disk format is the JAX package's, byte for byte: the same
`manifest.json` tensor table (flattened `params.<path>` / `opt.m.<path>`
keys, numpy dtype names, offsets, `fnv1a64_u64_stride` digests) and the
same `payload.aceapex`, so a checkpoint written by either package
restores in the other. bf16 tensors travel as their raw 16-bit words
(`ml_dtypes` is never needed).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.format import fnv1a64_u64_stride
from repro_torch.launch.mesh import shard_slices
from repro_torch.training.convert import TORCH_TO_NP, tensor_to_numpy


@dataclasses.dataclass
class CheckpointConfig:
    directory: str
    keep_last: int = 3
    compress: bool = True
    block_size: int = 16 * 1024
    entropy: str = "rans"


def _raw(v) -> "tuple[str, list, np.ndarray]":
    """(numpy dtype name, shape, raw little-endian bytes) of a leaf."""
    if isinstance(v, torch.Tensor):
        name, arr = TORCH_TO_NP[v.dtype], tensor_to_numpy(v)
    else:
        arr = np.asarray(v)
        name = str(arr.dtype)
    raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
    return name, list(arr.shape), raw


def _from_raw(raw: np.ndarray, name: str, shape, device) -> torch.Tensor:
    buf = raw.copy()                       # aligned, writable
    if name == "bfloat16":
        t = torch.from_numpy(buf.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(buf.view(np.dtype(name)))
    return t.reshape(shape).to(device)


class Checkpointer:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        os.makedirs(cfg.directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Dict, extra: Optional[Dict] = None
             ) -> str:
        flat = _flatten(state)
        manifest = {"step": step, "time": time.time(),
                    "compress": self.cfg.compress,
                    "extra": extra or {}, "tensors": {}}
        payload_parts = []
        off = 0
        for k in sorted(flat):
            name, shape, raw = _raw(flat[k])
            manifest["tensors"][k] = {
                "dtype": name, "shape": shape,
                "offset": off, "nbytes": int(raw.size),
                "fnv": f"{fnv1a64_u64_stride(raw):016x}",
            }
            payload_parts.append(raw)
            off += raw.size
        payload = (np.concatenate(payload_parts) if payload_parts
                   else np.zeros(0, np.uint8))

        d = os.path.join(self.cfg.directory, f"step_{step:08d}")
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        if self.cfg.compress:
            from repro_torch.core.encoder import encode
            from repro_torch.core.format import serialize
            archive = encode(payload.tobytes(),
                             block_size=self.cfg.block_size,
                             mode="ra", entropy=self.cfg.entropy)
            with open(os.path.join(tmp, "payload.aceapex"), "wb") as f:
                f.write(serialize(archive))
            manifest["payload_ratio"] = archive.ratio
        else:
            with open(os.path.join(tmp, "payload.bin"), "wb") as f:
                f.write(payload.tobytes())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)             # atomic publish
        self._gc()
        return d

    # --------------------------------------------------------------- restore
    def _steps(self):
        return sorted(int(n.split("_")[1]) for n in os.listdir(
            self.cfg.directory) if n.startswith("step_")
            and not n.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device="cuda",
                shardings: Optional[Dict] = None) -> Dict:
        """The state saved at `step` (default the latest) as tensors on
        `device`, plus its manifest under `"_manifest"`. A compressed
        payload decodes on `device` (`Decoder.decode_all`); every tensor's
        digest is checked before it is trusted.

        `shardings` maps flat tensor paths ("params.w") to `(mesh, spec)`
        pairs: such a path restores as a list, one tensor a mesh device
        (in `mesh.devices.flat` order) holding the slice a JAX
        `NamedSharding(mesh, PartitionSpec(*spec))` would place there
        (`launch.mesh.shard_slices`). Paths with no entry restore whole
        on `device`."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no checkpoint found")
        d = os.path.join(self.cfg.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["compress"]:
            from repro_torch.core.decoder import Decoder
            from repro_torch.core.format import deserialize
            with open(os.path.join(d, "payload.aceapex"), "rb") as f:
                archive = deserialize(f.read())
            payload = Decoder(archive, device=device).decode_all()
        else:
            payload = np.fromfile(os.path.join(d, "payload.bin"), np.uint8)

        flat = {}
        for k, meta in manifest["tensors"].items():
            raw = payload[meta["offset"]:meta["offset"] + meta["nbytes"]]
            if f"{fnv1a64_u64_stride(raw):016x}" != meta["fnv"]:
                raise AssertionError(f"digest mismatch restoring {k}")
            if shardings is not None and k in shardings:
                mesh, spec = shardings[k]
                whole = _from_raw(raw, meta["dtype"], meta["shape"], "cpu")
                flat[k] = [whole[sl].to(dev).clone() for sl, dev in zip(
                    shard_slices(mesh, spec, meta["shape"]),
                    mesh.devices.flat)]
            else:
                flat[k] = _from_raw(raw, meta["dtype"], meta["shape"],
                                    device)
        state = _unflatten(flat)
        state["_manifest"] = manifest
        return state

    def _gc(self):
        for s in self._steps()[:-self.cfg.keep_last]:
            shutil.rmtree(os.path.join(self.cfg.directory,
                                       f"step_{s:08d}"), ignore_errors=True)


def _flatten(tree, prefix="") -> Dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _unflatten(flat: Dict) -> Dict:
    out: Dict = {}
    for k, v in flat.items():
        parts = k.split(".")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out
