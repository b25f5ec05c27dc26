"""Device meshes and the data-parallel process group.

The reference is single-controller: one process owns a
`jax.sharding.Mesh`, and `shard_map` runs the same decode on every
device of it. The port keeps that shape for residency: a `Mesh` is an
ndarray of `torch.device`s with axis names, and one process drives a
decode on each device of it. A device may repeat: that is how one card
carries a 4-shard partition, and how the CPU tests carry a mesh of N
`cpu` shards. Data-parallel training reduces across ranks with
`torch.distributed` (NCCL on cards, gloo on the CPU); there
`make_local_mesh` spans the world of the process group, one entry a
rank.

Functions, not module-level constants: importing this module touches no
device and no process group.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """`devices` (an object ndarray of `torch.device`, of the mesh's
    shape) named by `axis_names`, one name a dimension."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order (as `jax.sharding.Mesh`)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and list(self.devices.flat) == list(other.devices.flat))

    def __hash__(self) -> int:
        return hash((self.axis_names, self.devices.shape,
                     tuple(str(d) for d in self.devices.flat)))


def _local_devices() -> list:
    """One entry per visible card, or the CPU when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return ([torch.device("cuda", i) for i in range(n)] if n
            else [torch.device("cpu")])


def _indexed(device) -> torch.device:
    """`device` with its card index ("cuda" → the current card), so a
    mesh entry compares equal to the device of a tensor placed there."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of `shape` named `axes` over `devices` (default one entry
    per visible card). A device may repeat: a 4-shard partition on one
    card is `make_mesh((4,), ("data",), ["cuda:0"] * 4)`."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"rank")
    devs = _local_devices() if devices is None else [_indexed(d)
                                                     for d in devices]
    if int(np.prod(shape)) != len(devs):
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} "
                         f"devices, got {len(devs)}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(devices=arr.reshape(shape), axis_names=axes)


def make_local_mesh(model_parallel: int = 1) -> Mesh:
    """Whatever this host has, as (n / model, model) over ("data",
    "model"): one entry per visible card, or, under an initialised
    `torch.distributed` process group, one a rank of its world (rank r
    on card r mod the card count under NCCL, on the CPU under gloo).
    Never repeats a card."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if dist.get_backend() == "nccl":
            n_cards = torch.cuda.device_count()
            devs = [torch.device("cuda", r % n_cards) for r in range(world)]
        else:
            devs = [torch.device("cpu")] * world
    else:
        devs = _local_devices()
    dp = max(1, len(devs) // model_parallel)
    return make_mesh((dp, model_parallel), ("data", "model"),
                     devs[:dp * model_parallel])


def dp_axes(mesh: Mesh) -> tuple:
    """The batch-sharding axes present in this mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def mesh_shards(mesh: Mesh, axes: Tuple[str, ...]) -> int:
    """Number of shards a split over `axes` of `mesh` makes."""
    return int(np.prod([mesh.shape[a] for a in axes]))


def shard_devices(mesh: Mesh, axes: Tuple[str, ...]) -> list:
    """The device of each shard of a split over `axes`, in shard order
    (row-major over `axes`); the mesh's other axes are taken at index 0,
    where the reference replicates over them."""
    order = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.axis_names)) if i not in order]
    devs = np.transpose(mesh.devices, order + rest)
    return list(devs.reshape(mesh_shards(mesh, axes), -1)[:, 0])


def shard_slices(mesh: Mesh, spec: Sequence, shape: Sequence[int]) -> list:
    """The slice of a `shape` array that each mesh device holds under the
    partition spec `spec` (one entry a dimension: None, an axis name or a
    tuple of names), in `mesh.devices.flat` order — split as JAX splits a
    `PartitionSpec`: a dimension over k shards takes chunks of
    ceil(n / k), the last one shorter; dimensions past `spec` and axes it
    does not name are replicated."""
    sizes = mesh.shape
    out = []
    for pos in np.ndindex(*mesh.devices.shape):
        coord = dict(zip(mesh.axis_names, pos))
        sl = []
        for d, n in enumerate(shape):
            entry = spec[d] if d < len(spec) else None
            if entry is None:
                sl.append(slice(0, n))
                continue
            names = (entry,) if isinstance(entry, str) else tuple(entry)
            idx, count = 0, 1
            for a in names:
                idx = idx * sizes[a] + coord[a]
                count *= sizes[a]
            chunk = -(-n // count)
            sl.append(slice(min(idx * chunk, n), min((idx + 1) * chunk, n)))
        out.append(tuple(sl))
    return out


@contextlib.contextmanager
def dp_group(device="cuda"):
    """The data-parallel process group for the body of a `with`: the one
    already initialised, else torchrun's (its environment names rank and
    world), else a world of one rendezvoused through a `FileStore` in a
    temporary directory, so no network is needed. NCCL for a CUDA
    `device`, gloo for the CPU. A group this call created is destroyed on
    exit, also when the body raises."""
    if dist.is_initialized():
        yield
        return
    dev = _indexed(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tmp = None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        tmp = tempfile.mkdtemp(prefix="dp_group_")
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
