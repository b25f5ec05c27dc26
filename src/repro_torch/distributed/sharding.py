"""Logical-axis sharding rules (2-D: tensor-parallel × FSDP), the
reference's table and its `shard()` constraint on DTensors.

Every parameter/activation dim carries a logical name; the rule table maps
it to mesh axes. Defaults implement:

  TP     out-features ("ffn", "heads", "vocab", "qk")  → "model"
  FSDP   in-features ("embed" = d_model)               → "data"
  DP     batch                                         → ("pod", "data")
  SP     decode-time KV sequence ("kv_seq")            → "model"

A spec is a plain tuple with one entry a dimension: None, a mesh axis
name, or a tuple of names (the form `launch/mesh.py::shard_slices` and
`Checkpointer.restore(shardings=)` take). A mesh is anything with axis
names and sizes: the port's `launch/mesh.Mesh`, a
`torch.distributed.device_mesh.DeviceMesh` with dim names, or a stand-in
with `axis_names` and a `shape` dict.

`shard(x, axes)` is the counterpart of the reference's
`with_sharding_constraint` by logical axes. With no ambient mesh, or on a
plain tensor, it returns `x` itself: every path that trains or serves
runs so. Under `mesh_context(device_mesh)` (the dry-run's fake world,
`launch/dryrun.py`) it redistributes a DTensor to the rules' placements,
sanitised as the reference's `mode="constraint"` does: a dimension at or
above its shard count keeps its axes (DTensor shards it unevenly, as XLA
pads), one below it is replicated. Partial values (a vocab-sharded
embedding lookup, a contraction over a sharded dimension) are reduced to
replicas first: DTensor cannot reduce-scatter a masked partial.

Of the reference's `compat.py`: `mesh_context` is the context here that
installs the ambient mesh for `shard()`; `make_mesh` is
`launch/mesh.make_mesh`, `shard_map` the process group of
`training/train_step.make_manual_dp_step`, and `cost_analysis` the
dry-run's counting mode (`launch/dryrun.py::CostMode`, the same
"flops" and "bytes accessed" keys). The port has no `compat.py`.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np

# logical axis -> mesh axes (None = replicated)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "blocks": "data",          # archive-shard dim of a mesh-partitioned
                               # archive's stacked per-shard planes
    "seq": None,
    "kv_seq": "model",         # decode-time flash-decode sharding
    "embed": "data",           # FSDP dim on weights
    "embed_act": None,         # activations keep d_model replicated
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "vocab": "model",
    "experts": None,           # looped; expert ffn dims carry "ffn"
    "layers": None,            # stacked layer dim
    "frames": None,
    "conv": None,
}


def make_rules(**overrides):
    r = dict(DEFAULT_RULES)
    r.update(overrides)
    return r


# Active rule set for in-model constraints (models call shard() without a
# rules argument; the dry-run installs its cell's rules here).
_ACTIVE_RULES: Optional[dict] = None
# The ambient mesh `shard()` resolves against (`mesh_context`).
_AMBIENT_MESH = None


def set_active_rules(rules: Optional[dict]) -> None:
    global _ACTIVE_RULES
    _ACTIVE_RULES = rules


@contextlib.contextmanager
def mesh_context(mesh):
    """Install `mesh` (a `DeviceMesh` with dim names) as the ambient mesh
    of `shard()` for the body of a `with`."""
    global _AMBIENT_MESH
    prev, _AMBIENT_MESH = _AMBIENT_MESH, mesh
    try:
        yield mesh
    finally:
        _AMBIENT_MESH = prev


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of any mesh this module takes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                      # DeviceMesh
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def spec_for(axes: Tuple[Optional[str], ...], rules=None,
             mesh=None) -> tuple:
    """Map logical axis names to a spec under `rules`. Axes not in the
    mesh (e.g. "pod" on a single-pod mesh) are dropped. A mesh axis may
    appear only once per spec: the FIRST logical dim claiming it wins
    (e.g. under seq→model rules, logits (batch, seq, vocab) shard seq and
    leave vocab replicated)."""
    rules = rules or DEFAULT_RULES
    names = set(axis_sizes(mesh)) if mesh is not None else None
    used: set = set()

    def resolve(a):
        if a is None:
            return None
        m = rules.get(a, None)
        if m is None:
            return None
        if isinstance(m, tuple):
            kept = tuple(x for x in m
                         if (names is None or x in names) and x not in used)
            used.update(kept)
            # one kept axis is stored bare, as `PartitionSpec` stores it
            return (kept if len(kept) > 1 else kept[0]) if kept else None
        if (names is not None and m not in names) or m in used:
            return None
        used.add(m)
        return m

    return tuple(resolve(a) for a in axes)


def sanitize_spec(shape: Tuple[int, ...], spec: tuple, mesh,
                  mode: str = "arg") -> tuple:
    """Make a spec legal/sane for the given shape.

    mode="arg": arguments need divisibility — drop axes where
    dim % shards != 0 (whisper's odd vocab 51865, 4 xLSTM heads...).
    mode="constraint": constraints may pad — only drop axes where
    dim < shards (padding beats replication above that)."""
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None if i >= len(shape) else entry)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = int(np.prod([sizes[a] for a in axes]))
        ok = (shape[i] % n == 0) if mode == "arg" else (shape[i] >= n)
        out.append(entry if n and ok else None)
    return tuple(out)


def named_sharding(mesh, axes: Tuple[Optional[str], ...],
                   rules=None) -> tuple:
    """(mesh, spec) of logical `axes` under `rules`."""
    return mesh, spec_for(axes, rules, mesh)


def arg_sharding(mesh, shape: Tuple[int, ...],
                 axes: Tuple[Optional[str], ...], rules=None) -> tuple:
    """(mesh, spec) for an argument: logical axes → spec → sanitized."""
    return mesh, sanitize_spec(shape, spec_for(axes, rules, mesh), mesh)


def shard_count(spec: tuple, mesh) -> int:
    """How many pieces `spec` cuts an array into on `mesh`."""
    sizes = axis_sizes(mesh)
    n = 1
    for entry in spec:
        if entry is not None:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                n *= sizes[a]
    return n


def placements(spec: tuple, device_mesh) -> list:
    """DTensor placements of `spec` on `device_mesh`, one a mesh dim:
    `Shard(d)` where tensor dim d names that mesh axis, else
    `Replicate()`. A tuple entry shards one dim over several mesh axes,
    in mesh order (JAX's order for the reference's ("pod", "data"))."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for d, entry in enumerate(spec):
        if entry is not None:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                owner[a] = d
    return [Shard(owner[a]) if a in owner else Replicate()
            for a in device_mesh.mesh_dim_names]


def shard(x, axes: Tuple[Optional[str], ...], rules=None, mesh=None):
    """The reference's `shard()`: a sharding constraint by logical axes.

    Resolved against `mesh` or the ambient mesh (`mesh_context`). With
    neither, or when `x` is a plain tensor, it returns `x` itself."""
    m = mesh if mesh is not None else _AMBIENT_MESH
    if m is None:
        return x
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor):
        return x
    rules = rules or _ACTIVE_RULES
    spec = sanitize_spec(tuple(x.shape), spec_for(axes, rules, m), m,
                         mode="constraint")
    if any(isinstance(p, Partial) for p in x.placements):
        x = x.redistribute(m, [Replicate() if isinstance(p, Partial) else p
                               for p in x.placements])
    return x.redistribute(m, placements(spec, m))

