"""Multi-pod dry-run: every (architecture × input shape × mesh) cell's
per-device argument bytes, FLOPs, bytes, collectives and roofline terms
on the H100 constants, with no card and no allocation.

The reference lowers and compiles each cell with XLA over 512 fake host
devices and reads `memory_analysis()`, `cost_analysis()` and the HLO
text. PyTorch has no such compiler; the port builds the same cell (the
reference's structs, logical axes and rules) and then:

- argument and output bytes: each struct's bytes over its sanitised
  spec's shard count (argument specs are sanitised to divisibility, as
  the reference's are), summed — no trace needed;
- counts: the step runs once on meta tensors as DTensors over a
  `DeviceMesh` of the production shape in a fake process group of that
  many ranks (`fake_world`), the parameters, inputs and caches placed by
  the rules (`distributed/sharding.placements`) and every model `shard()`
  site a `redistribute`. `CostMode` sees the LOCAL ops of rank 0 (it
  hands DTensor ops to DTensor and counts what DTensor runs on the local
  shards), so its numbers are per device, as `cost_analysis` is:
  "flops" are `torch.utils.flop_counter`'s formulas (matrix products;
  XLA also counts elementwise ops), "bytes accessed" each local op's
  inputs plus outputs (eager, unfused: XLA counts a fused program, so
  these are larger), collectives the `_c10d_functional` ops DTensor
  ran, by kind, at their per-device output bytes. The kinds are
  DTensor's choices, not XLA's partitioner's (a Partial → Shard move is
  a reduce-scatter); a Shard(i) → Shard(j) move, which a "cpu" group
  runs as an all-gather and a chunk, counts as the one all-to-all a
  card's group runs (`_alltoall_as_one`);
- `temp_size_in_bytes` has no twin (XLA's buffer assignment): the port
  reports the peak of live bytes the traced step's local ops allocated
  on one rank, an estimate (the zeros of the loss gather's backward
  placed as the logits are, as XLA places them).

DTensor's placements differ between PyTorch versions: 2.11 refuses the
flatten of a batch and a sequence sharded on two mesh dims that every
`_mm` of a seq-sharded activation does, which `CostMode` runs on the
shards ("flatten" fallbacks), as 2.13 places it. On a mesh of three dims
(the multi-pod (2, 16, 16)) `CostMode` does so before DTensor sees such a
view, on both versions: 2.13's strided placement of it sends every
redistribution into a graph search that outlasts the trace. There it
also reduces a product's partial sums before the product and aligns the
operands of an elementwise op without a strategy; a 2-D mesh keeps
DTensor's own route (`_AHEAD_NDIM`).

`CostMode` is the port's counterpart of the reference's
`compat.cost_analysis` (the record's "flops" and "bytes accessed"), and
`distributed/sharding.mesh_context` of its `compat.mesh_context`.

Depth is cut as the reference cuts it (`_depth_plan`/`_depth_cfg`): two
depths are traced and each metric fitted linearly to the full depth,
which is exact for a program linear in depth. The port walks its layers
and the sLSTM's steps in Python loops, so a trace counts every step (the
reference adds `_slstm_analytic` because XLA counts a scan body once);
for xLSTM's train and prefill cells the sequence is cut too, to two
multiples of the mLSTM chunk (2 and 4; 4 and 8 on a 3-D mesh), and
fitted linearly in S (the family has no attention, so its cost is
A + B·S + d·(C + D·S)).

Usage (host work on meta tensors: no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
      --out build/dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses as dc
import functools
import json
import os
import time
import traceback
import weakref
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import SHAPES_BY_NAME, all_configs, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import (arg_sharding,
                                              make_rules, mesh_context,
                                              placements, set_active_rules,
                                              shard_count)
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.models import common as cm
from repro_torch.models.registry import build_model
from repro_torch.roofline import hlo_costs as rl
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import make_train_step

ATTN_KV_CHUNK = 1024          # the reference's blockwise attention chunk


# ------------------------------------------------------------ fake world
@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of `n` ranks (this process is rank 0) for the
    body of a `with`: collectives record and move nothing. Refuses to
    start over an initialised group, and destroys its own on exit."""
    if dist.is_initialized():
        raise RuntimeError("the dry-run needs its own fake process group, "
                           "but one is already initialised")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:                  # internal API of PyTorch
        raise ImportError(
            "the dry-run needs PyTorch's fake process group "
            "(torch.testing._internal.distributed.fake_pg.FakeStore), "
            "which this PyTorch does not have") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def device_mesh(mesh):
    """The `DeviceMesh` of the port `Mesh` `mesh`'s shape and axis names
    in the current (fake) world."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(mesh.devices.shape),
                            mesh_dim_names=tuple(mesh.axis_names))


# ------------------------------------------------------------- counting
_COLL_KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
               "reduce_scatter": "reduce-scatter",
               "all_to_all": "all-to-all", "permute": "collective-permute",
               "send": "collective-permute", "recv": "collective-permute"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _fresh(func) -> bool:
    return all(r.alias_info is None for r in func._schema.returns)


_PROPAGATING = [0]


@contextlib.contextmanager
def _marking_propagation():
    """While DTensor works out an op's sharding (on meta tensors of the
    global shape, or fake ones), `CostMode` counts nothing: only the ops
    DTensor then runs on the local shards are the rank's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    names = [n for n in vars(ShardingPropagator)
             if n.lstrip("_").startswith("propagate")
             and callable(vars(ShardingPropagator)[n])]
    if "propagate" not in names:
        raise RuntimeError("this PyTorch's DTensor has no "
                           "ShardingPropagator.propagate to mark")
    saved = {n: vars(ShardingPropagator)[n] for n in names}

    def marked(orig):
        @functools.wraps(orig)
        def run(*a, **k):
            _PROPAGATING[0] += 1
            try:
                return orig(*a, **k)
            finally:
                _PROPAGATING[0] -= 1
        return run

    for n, f in saved.items():
        setattr(ShardingPropagator, n, marked(f))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(ShardingPropagator, n, f)


@contextlib.contextmanager
def _alltoall_as_one():
    """DTensor moves a Shard(i) → Shard(j) on one mesh dim with an
    all-to-all, which a process group on "cpu" devices runs as an
    all-gather and a chunk. For the body of a `with`, the running
    `CostMode` records each such move as the one all-to-all of its
    per-device output bytes that a card's group runs, and counts none of
    the stand-in's ops."""
    from torch.distributed.tensor import placement_types as pt
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    orig = getattr(pt, "shard_dim_alltoall", None)
    if orig is None:
        raise RuntimeError("this PyTorch's DTensor has no "
                           "placement_types.shard_dim_alltoall to mark")

    @functools.wraps(orig)
    def one(*a, **k):
        _PROPAGATING[0] += 1
        try:
            out = orig(*a, **k)
        finally:
            _PROPAGATING[0] -= 1
        mode = _get_current_dispatch_mode()
        if isinstance(mode, CostMode):
            mode.collectives.append(("all-to-all", _nbytes(out)))
            mode._hold(out)
        return out

    pt.shard_dim_alltoall = one
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


FALLBACKS = ("masked", "partial", "replicate", "local", "flatten", "whole")
# what CostMode does where DTensor cannot run an op on its operands'
# placements: "masked" all-reduces a masked embedding partial, "partial"
# reduces partial sums, "replicate" replicates the shards of one mesh
# dim, "local" runs an in-place op on its target's own shard (or an
# elementwise op with no sharding strategy on the shards), "flatten"
# runs a view that flattens dims sharded on different mesh dims on the
# shards (DTensor 2.11 refuses it; `_flatten_local`), "whole" runs an op
# with no sharding strategy on whole tensors


def fmt_fallbacks(fallbacks: Dict) -> str:
    return ", ".join(f"{k} {f['count']} ({f['bytes']:.3e} B)"
                     for k, f in fallbacks.items() if f["count"])


_UNPLACEABLE = (RuntimeError, NotImplementedError)
_DTENSOR_RULES = (os.path.join("distributed", "tensor", "_ops"),
                  os.path.join("distributed", "tensor", "_redistribute.py"))
_DTENSOR_LOCAL = os.path.join("distributed", "tensor", "_dispatch.py")


def _unplaceable(e) -> bool:
    """Whether DTensor refused an op's placements: it found no sharding
    strategy, or its strategies or redistribution planner raised (an
    uneven or sharded dim a view cannot split or flatten without a
    redistribution, a Shard to Partial move; the wording differs between
    PyTorch versions, where it is raised does not), or the local op it
    ran on the shards it had planned failed (a view of a shard whose
    planned shape is not the shard's, seen on the 3-D mesh; the model's
    own errors fail on the global shapes, in the planning). Any other
    error fails the trace."""
    while e is not None:
        if isinstance(e, NotImplementedError) \
                and "sharding strategy" in str(e):
            return True
        frames = []
        tb = e.__traceback__
        while tb is not None:
            frames.append(tb.tb_frame.f_code)
            tb = tb.tb_next
        if frames and any(r in frames[-1].co_filename
                          for r in _DTENSOR_RULES):
            return True
        if any(_DTENSOR_LOCAL in f.co_filename and "local_results" in f.co_name
               for f in frames):
            return True
        e = e.__cause__
    return False


def _moved(t, placements):
    """The DTensor `t` redistributed to `placements`. `CostMode`'s
    fallbacks run below autograd; in a backward, a redistribute of a
    tensor that requires grad ends in a `detach_` of its output, which
    DTensor 2.11 has no strategy for, so there `t` is detached first."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    if t.requires_grad and not any(
            torch.ops.aten.detach_.default in getattr(prop, n, {})
            for n in ("op_strategy_funcs", "op_to_rules",
                      "op_single_dim_strategy_funcs")):
        t = t.detach()
    return t.redistribute(t.device_mesh, placements)


def _local_operands(target, args, kwargs):
    """`(args, kwargs)` of an in-place op on `target`'s own shard: every
    other DTensor placed as the target on each mesh dim (replicated on a
    dim the target shards where their sizes differ, as the written slice
    does, and wherever their ranks differ), then its local tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def local(t):
        if t is target:
            return t.to_local()
        p = []
        for q in target.placements:
            keep = t.ndim == target.ndim and not (
                isinstance(q, Shard)
                and t.shape[q.dim] != target.shape[q.dim])
            p.append(q if keep and not q.is_partial() else Replicate())
        if p != list(t.placements):
            t = _moved(t, p)
        return t.to_local()
    return pytree.tree_map_only(DTensor, local, (args, kwargs))


_VIEWS = ("view", "_unsafe_view", "reshape")
_AHEAD_NDIM = 3
# on a mesh of this many dims or more, `CostMode` places strided flattens,
# products of partial sums and elementwise ops without a strategy ahead
# of DTensor; a smaller mesh keeps DTensor's own route, as the single-pod
# grid was read
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _view_groups(src, dst):
    """[(in_dims, out_dims)]: a view from shape `src` to `dst` as groups
    of equal products (a dim kept, dims flattened into one, or one split
    into several); trailing size-1 dims join the last group. None where
    the shapes do not pair so (an empty dim, a -1 left to infer)."""
    if not src or not dst or min(src) < 1 or min(dst) < 1:
        return None
    groups, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        ins, outs, a, b = [i], [j], src[i], dst[j]
        i, j = i + 1, j + 1
        while a != b:
            if a < b and i < len(src):
                ins.append(i)
                a, i = a * src[i], i + 1
            elif b < a and j < len(dst):
                outs.append(j)
                b, j = b * dst[j], j + 1
            else:
                return None
        groups.append((ins, outs))
    if any(d != 1 for d in src[i:]) or any(d != 1 for d in dst[j:]):
        return None
    groups[-1][0].extend(range(i, len(src)))
    groups[-1][1].extend(range(j, len(dst)))
    return groups


def _local_shape(shape, placements, mesh):
    """The local shape of a tensor of global `shape` placed so (Shard,
    Replicate or Partial, each split even); None otherwise."""
    from torch.distributed.tensor import Shard
    local = list(shape)
    for k, p in enumerate(placements):
        if type(p) is Shard:
            if local[p.dim] % mesh.size(k):
                return None
            local[p.dim] //= mesh.size(k)
        elif not (p.is_replicate() or p.is_partial()):
            return None
    return local


def _contiguous(local, mesh, placements, shape):
    """`local` as a DTensor of global `shape` placed so, contiguous."""
    from torch.distributed.tensor import DTensor
    stride = tuple(int(np.prod(shape[d + 1:])) for d in range(len(shape)))
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _masked(out) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(out, DTensor) and any(
        "MaskPartial" in type(p).__name__ for p in out.placements)


def _reduce_masked(out):
    """A vocab-sharded embedding lookup returns a masked partial sum whose
    mask DTensor keeps for one reduction only; a value read twice (the
    residual stream) would lose it. Reduce it at once (an all-reduce), as
    XLA reduces the gather's partial result."""
    from torch.distributed.tensor import Replicate
    return _moved(out, [
        Replicate() if "MaskPartial" in type(p).__name__ else p
        for p in out.placements])


class CostMode(TorchDispatchMode):
    """Counts one rank's local work, the port's `cost_analysis`:
    `flops` (`torch.utils.flop_counter` formulas), `bytes` (each
    non-view op's tensor inputs plus outputs), `collectives`
    [(kind, per-device output bytes)], `peak_live` (the most bytes the
    ops' fresh outputs held at once) and `fallbacks` {kind: {"count",
    "bytes"}} (FALLBACKS, with the collective bytes each kind ran).

    A DTensor op is run by DTensor with this mode pushed again, so the
    local ops it runs on the shards come back here and are counted;
    DTensor's sharding propagation on global fake tensors is skipped.
    Where DTensor refuses an op's placements (`_unplaceable`: an uneven
    split of 12 heads over 16 shards in a view, no sharding strategy),
    partial sums are reduced, then the operands' shards replicated one
    mesh dim at a time, the last first, and the op run again: the
    replicate-before-op XLA's partitioner inserts by itself, its
    all-gathers counted. An elementwise op DTensor has no strategy for
    (`log_sigmoid_backward`) runs on the shards; any other such op runs
    last on whole local tensors, its result replicated. An in-place op
    keeps its target's placement: where DTensor refuses it or would move
    the target (gather a cache sharded along the written dim), its
    counts are undone and it runs on the target's own shard. Any other
    error fails the trace. A view DTensor refuses that flattens dims
    sharded on different mesh dims runs on the shards, and a view that
    splits such a dim back too (`_flatten_local`, `_unflatten_local`). On
    a mesh of three or more dims such a flatten runs on the shards before
    DTensor sees it, a product's partial sums are scattered first
    (`_scatter_partials`), an elementwise op without a strategy runs on
    its operands moved to one placement, and a view DTensor refuses
    keeps its partial sums. The zeros of `gather`'s backward are placed
    as the gathered tensor (`_zeros_as_gathered`). On plain tensors it
    counts every op."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = []
        self.live = 0
        self.peak_live = 0
        self.fallbacks = {}
        self._in_dtensor = False
        # (gathered shape, dtype, gather's output shape) -> the gathered
        # tensors' (mesh, placements), one entry a gather not yet undone
        self._gathered = {}
        # (flattened sizes, mesh dims sharding them) -> {mesh dim: index
        # of the flattened dim it shards}, one entry a `_flatten_local`
        self._flats = {}

    def _free(self, n: int) -> None:
        self.live -= n

    def _hold(self, t) -> None:
        """Count `t`, a fresh output, live until it is freed."""
        n = _nbytes(t)
        self.live += n
        weakref.finalize(t, self._free, n)
        self.peak_live = max(self.peak_live, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._in_dtensor:
                return NotImplemented   # DTensor's handler, this mode on
            return self._run_dtensor(func, args, kwargs)
        out = func(*args, **kwargs)
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if _PROPAGATING[0] or any(isinstance(t, FakeTensor)
                                  for t in ins + outs):
            return out      # DTensor's sharding propagation (global shapes)
        if func.namespace.startswith("_c10d_functional") \
                or func.namespace == "c10d":
            kind = next((k for n, k in _COLL_KINDS.items()
                         if n in func.__name__), None)
            if kind is not None:
                self.collectives.append((kind, sum(_nbytes(t) for t in outs)))
            return out
        if _is_view(func):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        if _fresh(func):
            for t in outs:
                self._hold(t)
        return out

    def _note(self, kind: str, n: int) -> None:
        """Count one fallback of `kind` and the collective bytes it ran
        (those recorded after the first `n`)."""
        f = self.fallbacks.setdefault(kind, {"count": 0, "bytes": 0})
        f["count"] += 1
        f["bytes"] += sum(b for _, b in self.collectives[n:])

    def _pointwise_local(self, func, args, kwargs):
        """An op with no sharding strategy whose DTensor operands share
        one shape and one placement with no partial sum, and whose output
        has their local shape (`log_sigmoid_backward`), is elementwise:
        run on the local shards, its output so placed. On a mesh of three
        or more dims (`_AHEAD_NDIM`) operands of that shape placed
        otherwise are first moved to the first operand's placement (a
        chunk of a replicated dim, an all-to-all of a shard, a
        reduce-scatter of a partial sum; counted). None otherwise."""
        from torch.distributed.tensor import DTensor
        ds = [t for t in pytree.tree_leaves((args, kwargs))
              if isinstance(t, DTensor)]
        first = ds[0]
        if any(t.shape != first.shape for t in ds) \
                or any(p.is_partial() for p in first.placements):
            return None
        saved = (self.flops, self.bytes, len(self.collectives))
        if any(t.placements != first.placements for t in ds):
            if first.device_mesh.ndim < _AHEAD_NDIM:
                return None
            args, kwargs = pytree.tree_map_only(
                DTensor, lambda t: _moved(t, first.placements),
                (args, kwargs))
        local = first.to_local().shape
        out = func(*pytree.tree_map_only(DTensor, lambda t: t.to_local(),
                                         args),
                   **pytree.tree_map_only(DTensor, lambda t: t.to_local(),
                                          kwargs))
        if not isinstance(out, torch.Tensor) or out.shape != local:
            self.flops, self.bytes, n = saved
            del self.collectives[n:]
            return None
        self._note("local", saved[2])
        return DTensor.from_local(out, first.device_mesh, first.placements,
                                  run_check=False, shape=first.shape,
                                  stride=first.stride())

    def _scatter_partials(self, args):
        """A product's operand that holds partial sums, reduced and
        scattered first onto the dim the product keeps (the first
        operand's rows or batch, the second's columns; replicated where
        that dim does not split evenly), so each rank multiplies its
        share. DTensor weighs only communication, so it multiplies the
        whole partial sum on every rank where that moves no bytes, and on
        a 3-D mesh it does so at one sequence length and not at another,
        which breaks the fit in depth and sequence; XLA's partitioner
        reduces first. Counted as "partial"."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        out = list(args)
        for i, t in enumerate(args[:2]):
            if not isinstance(t, DTensor) \
                    or not any(p.is_partial() for p in t.placements):
                continue
            d, mesh = (0 if i == 0 else t.ndim - 1), t.device_mesh
            left, placements = t.shape[d], []
            for k, p in enumerate(t.placements):
                if type(p) is Shard and p.dim == d:
                    left //= mesh.size(k)
                elif p.is_partial():
                    if left % mesh.size(k):
                        p = Replicate()
                    else:
                        p, left = Shard(d), left // mesh.size(k)
                placements.append(p)
            n = len(self.collectives)
            out[i] = _moved(t, placements)
            self._note("partial", n)
        return tuple(out)

    def _flatten_local(self, func, args, kwargs):
        """A view that flattens dims sharded on different mesh dims, a
        sharded dim behind the first of its group (`_mm`'s (B, S, E) →
        (B·S, E) with B on "data" and S on "model", attention's (B, KV,
        G, S, D) → (B·KV, G·S, D), the mLSTM's (B, H, W, D) → (B·H, W, D)
        with B on ("pod", "data") and H on "model"), runs on the local
        shards: each mesh dim shards the output dim its input dim went
        into (a flattened dim nested, in mesh-dim order), as many rows a
        rank as the shards hold. DTensor 2.11 refuses such a view ("with
        dimension 1 being sharded"); 2.13 places it as a `_StridedShard`,
        whose every redistribution it plans by a graph search, which on a
        3-D mesh costs more than the rest of the trace together: there
        it runs here before DTensor sees it (`_run_dtensor`). The
        placements say each rank holds a contiguous block of the rows; it
        holds a strided set (its B rows' shards of S). The bytes and
        FLOPs of a row-wise op are the same either way, but the rows'
        order is not, so the flatten is recorded in `_flats` (the sizes
        it flattened and the mesh dims that shard them → which of those
        dims each mesh dim shards), and a view that splits such a dim
        back restores the placement it came from (`_unflatten_local`),
        whatever ops lay between (a product, a cast, a transpose, a
        time step's index). None where the view is not such a flatten (a
        split or a partial sum of a sharded dim, an uneven shard)."""
        from torch.distributed.tensor import DTensor, Shard
        t = args[0]
        if kwargs or not isinstance(t, DTensor):
            return None
        shape = tuple(args[1])
        groups = _view_groups(tuple(t.shape), shape)
        if groups is None:
            return None
        group_of = {d: g for g, (ins, _) in enumerate(groups) for d in ins}
        placements, src = [], {}
        for k, p in enumerate(t.placements):
            if p.is_replicate():
                placements.append(p)
                continue
            if type(p) is not Shard or t.shape[p.dim] % t.device_mesh.size(k):
                return None
            ins, outs = groups[group_of[p.dim]]
            if len(outs) != 1:
                return None
            placements.append(Shard(outs[0]))
            if len(ins) > 1:
                src.setdefault(outs[0], (tuple(t.shape[d] for d in ins),
                                         {}))[1][k] = ins.index(p.dim)
        if not any(any(m.values()) for _, m in src.values()):
            return None
        local, local_shape = t.to_local(), []
        for ins, outs in groups:
            if len(outs) == 1:
                local_shape.append(int(np.prod([local.shape[d]
                                                for d in ins])))
            else:
                local_shape.extend(shape[o] for o in outs)
        n = len(self.collectives)
        out = _contiguous(func(local, local_shape), t.device_mesh,
                          placements, shape)
        for sizes, m in src.values():       # size-1 dims left out
            big = [i for i, z in enumerate(sizes) if z > 1]
            self._flats[tuple(sizes[i] for i in big), tuple(sorted(m))] = {
                k: big.index(i) for k, i in m.items()}
        self._note("flatten", n)
        return out

    def _unflatten_local(self, func, args, kwargs):
        """A view that splits a dim back into the dims a `_flatten_local`
        flattened (the same sizes but for dims of size 1, sharded on the
        same mesh dims, in `_flats`) runs on the local shards too: each
        such mesh dim shards the dim it sharded before the flatten, any
        other placement follows its dim. None for any other view of a
        sharded dim, and for a view that splits no such dim."""
        from torch.distributed.tensor import Shard
        t = args[0]
        if kwargs:
            return None
        shape = tuple(args[1])
        groups = _view_groups(tuple(t.shape), shape)
        if groups is None:
            return None
        group_of = {d: g for g, (ins, _) in enumerate(groups) for d in ins}
        placements, split = [], False
        for k, p in enumerate(t.placements):
            if type(p) is Shard:
                ins, outs = groups[group_of[p.dim]]
                if len(ins) != 1:
                    return None
                if len(outs) > 1:
                    big = [o for o in outs if shape[o] > 1]
                    src = self._flats.get((
                        tuple(shape[o] for o in big),
                        tuple(j for j, q in enumerate(t.placements)
                              if type(q) is Shard and q.dim == p.dim)))
                    if src is None:
                        return None
                    p, split = Shard(big[src[k]]), True
                else:
                    p = Shard(outs[0])
            elif not (p.is_replicate() or p.is_partial()):
                return None
            placements.append(p)
        if not split:
            return None
        mesh, local = t.device_mesh, t.to_local()
        local_shape = _local_shape(shape, placements, mesh)
        if local_shape is None \
                or int(np.prod(local_shape)) != local.numel():
            return None
        return _contiguous(func(local, local_shape), mesh, placements,
                           shape)

    def _zeros_as_gathered(self, func, args, kwargs):
        """`gather`'s backward makes zeros of the gathered tensor's shape
        (`new_zeros` on the loss gradient, replicated) and scatters the
        gradient into them. They take the placement of the tensor that
        was gathered (the logits'), so each rank holds its shard of the
        B·S·V zeros, as XLA's partitioner places them. Only a `new_zeros`
        of a gathered tensor's shape and dtype, made on a gradient of
        that gather's output shape, is one; each gather places one. None
        for any other `new_zeros`."""
        t, size = args[0], tuple(args[1])
        key = (size, kwargs.get("dtype") or t.dtype, tuple(t.shape))
        if not self._gathered.get(key):
            return None
        mesh, placements = self._gathered[key][-1]
        local_shape = _local_shape(size, placements, mesh)
        if local_shape is None or mesh != t.device_mesh:
            return None
        self._gathered[key].pop()
        return _contiguous(func(t.to_local(), local_shape, **kwargs), mesh,
                           placements, size)

    def _run_dtensor(self, func, args, kwargs):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        aten = torch.ops.aten
        view = func._overloadpacket.__name__ in _VIEWS
        mesh = next(t.device_mesh for t in pytree.tree_leaves((args, kwargs))
                    if isinstance(t, DTensor))
        ahead = mesh.ndim >= _AHEAD_NDIM
        self._in_dtensor = True
        try:
            with self:
                if view and self._flats:
                    out = self._unflatten_local(func, args, kwargs)
                    if out is not None:
                        return out
                if view and ahead:
                    out = self._flatten_local(func, args, kwargs)
                    if out is not None:
                        return out
                if func is aten.new_zeros.default:
                    out = self._zeros_as_gathered(func, args, kwargs)
                    if out is not None:
                        return out
                if func is aten.gather.default:
                    src, index = args[0], args[2]
                    self._gathered.setdefault(
                        (tuple(src.shape), src.dtype, tuple(index.shape)),
                        []).append((src.device_mesh, tuple(src.placements)))
                if func in _PRODUCTS and ahead:
                    args = self._scatter_partials(args)
                target = args[0] if func._schema.is_mutable else None
                spec = getattr(target, "_spec", None)
                saved = (self.flops, self.bytes, len(self.collectives),
                         self.peak_live)
                try:
                    out = func(*args, **kwargs)
                    if spec is None or target._spec == spec:
                        if _masked(out):
                            n = len(self.collectives)
                            out = _reduce_masked(out)
                            self._note("masked", n)
                        return out
                    # DTensor moved an in-place op's target (gathered a
                    # cache sharded along the written dim): undo its counts
                    # and write on the target's own shard instead
                    target._spec = spec
                    self.flops, self.bytes, n, self.peak_live = saved
                    del self.collectives[n:]
                except _UNPLACEABLE as e:
                    if not _unplaceable(e):
                        raise
                    if view:
                        out = self._flatten_local(func, args, kwargs)
                        if out is not None:
                            return out
                    if isinstance(e, NotImplementedError) and target is None:
                        out = self._pointwise_local(func, args, kwargs)
                        if out is not None:
                            return out
                if target is not None:
                    # an in-place op (a cache write along a sharded dim)
                    # runs on the target's own shard, as XLA's partitioned
                    # dynamic_update_slice writes only there
                    n = len(self.collectives)
                    la, lk = _local_operands(target, args, kwargs)
                    self._note("local", n)
                    func(*la, **lk)
                    return target
                # reduce partial sums first (DTensor cannot reduce-scatter
                # a masked partial), then replicate shards a mesh dim at a
                # time, the last first; on a mesh of three or more dims a
                # view keeps its partial sums (it is linear in them)
                first = [] if view and ahead else [None]
                for k in first + list(reversed(range(mesh.ndim))):
                    def rep(t, k=k):
                        p = list(t.placements)
                        for i, q in enumerate(p):
                            if i == k or (k is None
                                          and isinstance(q, Partial)):
                                p[i] = Replicate()
                        return (t if p == list(t.placements)
                                else _moved(t, p))
                    n = len(self.collectives)
                    new = pytree.tree_map_only(DTensor, rep, (args, kwargs))
                    if all(a is b for a, b in zip(
                            pytree.tree_leaves(new),
                            pytree.tree_leaves((args, kwargs)))):
                        continue
                    args, kwargs = new
                    self._note("partial" if k is None else "replicate", n)
                    try:
                        return func(*args, **kwargs)
                    except _UNPLACEABLE as e:
                        if not _unplaceable(e):
                            raise
                # last, an op DTensor has no strategy for (or cannot
                # shard at all): run it on whole local tensors, replicated
                n = len(self.collectives)
                args, kwargs = pytree.tree_map_only(
                    DTensor, lambda t: _moved(
                        t, [Replicate()] * mesh.ndim).to_local(),
                    (args, kwargs))
                self._note("whole", n)
                out = func(*args, **kwargs)
                return pytree.tree_map_only(
                    torch.Tensor, lambda t: DTensor.from_local(
                        t, mesh, [Replicate()] * mesh.ndim,
                        run_check=False), out)
        finally:
            self._in_dtensor = False

    def metrics(self) -> Dict:
        """{"flops", "bytes", "temp", "coll_<kind>", "fb_<fallback>",
        "fb_<fallback>_bytes"}: the fallbacks' counts and the collective
        bytes they ran, a kind each (FALLBACKS)."""
        coll = rl.collective_bytes(self.collectives)
        fb = {}
        for k in FALLBACKS:
            f = self.fallbacks.get(k, {"count": 0, "bytes": 0})
            fb[f"fb_{k}"] = float(f["count"])
            fb[f"fb_{k}_bytes"] = float(f["bytes"])
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "temp": float(self.peak_live),
                **{f"coll_{k}": float(v) for k, v in coll.items()}, **fb}


# --------------------------------------------------------------- the cell
def _shardings_for(defs_axes: Dict, shapes: Dict, mesh, rules) -> Dict:
    """Argument shardings by logical axes, sanitized for divisibility
    against the actual tensor shapes (see sharding.sanitize_spec)."""
    return {k: arg_sharding(mesh, tuple(shapes[k].shape), a, rules)
            for k, a in defs_axes.items()}


SEQ_SHARD_FAMILIES = ("dense", "vlm", "whisper", "rglru")
# the reference's Megatron-SP residual-stream sharding (seq over "model"
# between blocks), adopted per family; not for MoE (the group-local
# dispatch needs S local) nor xLSTM (its chunk scan)


def rules_for(cfg) -> dict:
    if cfg.family in SEQ_SHARD_FAMILIES:
        return make_rules(seq="model", embed_act=None)
    return make_rules()


def _forward_fn(model, cfg, remat: str):
    def fn(params, batch):
        if cfg.family == "whisper":
            return model.forward(params, batch["tokens"], batch["frames"],
                                 remat=remat)
        if cfg.family == "vlm":
            return model.forward(params, batch["tokens"],
                                 mrope=batch.get("mrope"),
                                 img_embeds=batch.get("img_embeds"),
                                 remat=remat)
        return model.forward(params, batch["tokens"], remat=remat)
    return fn


def build_cell(cfg_or_arch, shape_name, mesh, remat: str = "full",
               rules=None):
    """→ (fn, arg_structs, in_shardings, out_shardings, donate, meta).
    Structs are meta tensors, shardings `(mesh, spec)` pairs in the
    structs' trees; `meta["out_structs"]` holds the outputs' structs.
    `shape_name` may be a `ShapeConfig`."""
    cfg = (cfg_or_arch if not isinstance(cfg_or_arch, str)
           else get_config(cfg_or_arch))
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES_BY_NAME[shape_name])
    model = build_model(cfg)
    rules = rules or rules_for(cfg)
    if shape.global_batch < int(np.prod([mesh.shape[a]
                                         for a in dp_axes(mesh)])):
        rules = dict(rules)
        rules["batch"] = None       # B=1 long-decode: replicate batch

    defs = model.param_defs()
    p_structs = cm.param_structs(defs)
    p_axes = {k: a for k, (s, a) in defs.items()}
    p_shard = _shardings_for(p_axes, p_structs, mesh, rules)

    in_structs = model.input_specs(shape)
    in_axes = model.input_axes(shape)
    in_shard = _shardings_for(in_axes, in_structs, mesh, rules)
    scalar = (mesh, ())

    if shape.kind == "train":
        step = make_train_step(model, AdamWConfig(), remat=remat)
        opt_structs = {
            "m": {k: cm.meta(v.shape, torch.float32)
                  for k, v in p_structs.items()},
            "v": {k: cm.meta(v.shape, torch.float32)
                  for k, v in p_structs.items()},
            "step": cm.meta((), torch.int32),
        }
        state_structs = {"params": p_structs, "opt": opt_structs}
        state_shard = {"params": p_shard,
                       "opt": {"m": p_shard, "v": p_shard, "step": scalar}}
        metrics = {k: cm.meta((), torch.float32)
                   for k in ("loss", "grad_norm", "lr")}
        fn = step
        args = (state_structs, in_structs)
        in_sh = (state_shard, in_shard)
        out_sh = (state_shard, {k: scalar for k in metrics})
        out_structs = (state_structs, metrics)
        donate = (0,)
    elif shape.kind == "prefill":
        fn = _forward_fn(model, cfg, remat)
        args = (p_structs, in_structs)
        in_sh = (p_shard, in_shard)
        logits = (shape.global_batch, shape.seq_len, cfg.vocab)
        out_sh = arg_sharding(mesh, logits, ("batch", "seq", "vocab"),
                              rules)
        out_structs = cm.meta(logits, torch.bfloat16)
        donate = ()
    else:  # decode
        B, S = shape.global_batch, shape.seq_len
        cache_structs = model.cache_specs(B, S)
        cache_shard = _shardings_for(model.cache_axes(), cache_structs,
                                     mesh, rules)

        def fn(params, cache, batch):
            return model.decode_step(params, cache, batch["tokens"])

        args = (p_structs, cache_structs, in_structs)
        in_sh = (p_shard, cache_shard, in_shard)
        out_sh = (arg_sharding(mesh, (B, cfg.vocab), ("batch", "vocab"),
                               rules), cache_shard)
        out_structs = (cm.meta((B, cfg.vocab), torch.bfloat16),
                       cache_structs)
        donate = (1,)

    meta = {"cfg": cfg, "shape": shape, "out_structs": out_structs}
    return fn, args, in_sh, out_sh, donate, meta


def _pairs(structs, shardings):
    """[(struct, (mesh, spec))] over trees of matching dicts and tuples."""
    if isinstance(structs, torch.Tensor):
        return [(structs, shardings)]
    if isinstance(structs, dict):
        return [p for k in structs for p in _pairs(structs[k], shardings[k])]
    return [p for s, h in zip(structs, shardings) for p in _pairs(s, h)]


def per_device_bytes(structs, shardings) -> int:
    """One device's bytes of `structs` placed by `shardings`: each
    struct's bytes over its spec's shard count (exact for divisible
    specs, as sanitised arguments are)."""
    return sum(_nbytes(t) // shard_count(spec, m)
               for t, (m, spec) in _pairs(structs, shardings))


def output_bytes(structs, shardings) -> int:
    """`per_device_bytes` of a step's outputs, plus the 8-byte index
    XLA's `output_size_in_bytes` counts for each leaf of a tuple output,
    so the two read alike."""
    n = len(_pairs(structs, shardings))
    return per_device_bytes(structs, shardings) + (8 * n if n > 1 else 0)


def _dtensors(structs, shardings, dmesh):
    """The structs as DTensors of meta local shards on `dmesh`."""
    from torch.distributed.tensor import DTensor
    if isinstance(structs, dict):
        return {k: _dtensors(v, shardings[k], dmesh)
                for k, v in structs.items()}
    if not isinstance(structs, torch.Tensor):
        return tuple(_dtensors(s, h, dmesh)
                     for s, h in zip(structs, shardings))
    spec = shardings[1]
    local = list(structs.shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            local[d] //= shard_count((entry,), dmesh)
    return DTensor.from_local(
        torch.empty(local, dtype=structs.dtype, device="meta"), dmesh,
        placements(spec, dmesh), run_check=False, shape=structs.shape,
        stride=structs.stride())


def count_cell(fn, args, in_sh, mesh, rules) -> Dict:
    """Trace `fn(*args)` once as DTensors on `mesh`'s shape in a fake
    world, under `rules`, blockwise attention at ATTN_KV_CHUNK; →
    `CostMode.metrics`."""
    from torch.distributed.tensor.experimental import implicit_replication
    with fake_world(mesh.size):
        dmesh = device_mesh(mesh)
        dargs = _dtensors(args, in_sh, dmesh)
        set_active_rules(rules)
        cm.set_attn_impl("blockwise", ATTN_KV_CHUNK)
        try:
            with mesh_context(dmesh), implicit_replication(), \
                    _marking_propagation(), _alltoall_as_one(), \
                    CostMode() as cost:
                fn(*dargs)
            del dargs
        finally:
            set_active_rules(None)
            cm.set_attn_impl("full")
        return cost.metrics()


# --------------------------------------------------------------- cost pass
# Two reduced-depth traces of the same cell, each metric fitted linearly
# in depth: exact for depth-linear programs. MoE expert compute is
# capacity-invariant in expert count (C·Ex = T·k·cf), so reduced expert
# counts keep expert flops exact.

def _depth_plan(cfg):
    """→ (d1, d2, full_units, tail_units) in 'unit' space (layers/groups)."""
    if cfg.family in ("dense", "vlm", "moe", "whisper"):
        return 1, 2, cfg.n_layers, 0.0
    if cfg.family == "xlstm":
        return 1, 2, cfg.n_layers // cfg.slstm_every, 0.0
    if cfg.family == "rglru":
        pat = len(cfg.layer_pattern)
        full_groups = cfg.n_layers // pat
        tail = (cfg.n_layers - full_groups * pat) / pat  # ≈ fraction of group
        return 1, 2, full_groups, tail
    raise ValueError(cfg.family)


def _depth_cfg(cfg, d: int):
    if cfg.family in ("dense", "vlm"):
        return dc.replace(cfg, n_layers=d)
    if cfg.family == "moe":
        return dc.replace(cfg, n_layers=d,
                          n_experts=min(cfg.n_experts, 16))
    if cfg.family == "whisper":
        return dc.replace(cfg, n_layers=d, n_enc_layers=d)
    if cfg.family == "xlstm":
        return dc.replace(cfg, n_layers=d * cfg.slstm_every)
    if cfg.family == "rglru":
        return dc.replace(cfg, n_layers=d * len(cfg.layer_pattern))
    raise ValueError(cfg.family)


def _measure_cell(cfg, d: int, shape_name, mesh, remat, rules,
                  depth_cfg_fn) -> Dict:
    """One reduced-depth trace → raw metrics dict."""
    fn, args, in_sh, _, _, _ = build_cell(depth_cfg_fn(cfg, d), shape_name,
                                          mesh, remat=remat, rules=rules)
    return count_cell(fn, args, in_sh, mesh, rules)


def _fit(m1: Dict, m2: Dict, x1: float, x2: float, x: float) -> Dict:
    """Each metric's line through (x1, m1) and (x2, m2), at x."""
    return {k: m1[k] + (m2[k] - m1[k]) / (x2 - x1) * (x - x1) for k in m1}


def cost_extrapolated(arch, shape_name, mesh, remat: str,
                      rules=None) -> Dict:
    """Two reduced-depth traces → per-metric linear fit → full depth (for
    xLSTM's train and prefill cells, at two cut sequence lengths too)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES_BY_NAME[shape_name])
    d1, d2, full_units, tail_units = _depth_plan(cfg)
    rules = rules or rules_for(cfg)
    units = full_units + tail_units

    def at_depths(shp) -> Dict:
        m1, m2 = (_measure_cell(cfg, d, shp, mesh, remat, rules,
                                _depth_cfg) for d in (d1, d2))
        return _fit(m1, m2, d1, d2, units)

    if cfg.family == "xlstm" and shape.kind != "decode":
        # linear in S at a fixed chunk: trace two multiples of the chunk,
        # 4 and 8 on a mesh of three dims, where DTensor places a group's
        # products otherwise at 2 chunks than at 4 (a group's all-gather
        # falls from 3.6e9 to 2.9e9 B a rank at xlstm-350m's train_4k
        # width), which a line in S cannot carry
        k = 4 if len(mesh.axis_names) >= _AHEAD_NDIM else 2
        Sa, Sb = k * cfg.mlstm_chunk, 2 * k * cfg.mlstm_chunk
        out = _fit(at_depths(dc.replace(shape, seq_len=Sa)),
                   at_depths(dc.replace(shape, seq_len=Sb)),
                   Sa, Sb, shape.seq_len)
    else:
        out = at_depths(shape)
    # clamp: a linear fit may go (slightly) negative when the non-layer
    # base dominates a tiny per-layer metric
    return {k: max(v, 0.0) for k, v in out.items()}


def _model_flops(cfg, shape) -> float:
    if shape.kind == "train":
        return rl.model_flops_train(cfg, shape.global_batch * shape.seq_len)
    if shape.kind == "prefill":                       # forward only
        return rl.model_flops_train(
            cfg, shape.global_batch * shape.seq_len) / 3.0
    return rl.model_flops_decode(cfg, shape.global_batch, shape.seq_len)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             remat: str = "full", rules=None, verbose: bool = True,
             cost_pass: bool = True) -> Dict:
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_dev = mesh.size
    if rules is None:
        rules = rules_for(get_config(arch))
    t0 = time.time()
    fn, args, in_sh, out_sh, donate, meta = build_cell(
        arch, shape_name, mesh, remat=remat, rules=rules)
    cfg, shape = meta["cfg"], meta["shape"]
    t_lower = time.time() - t0
    if cost_pass:
        cost = cost_extrapolated(arch, shape_name, mesh, remat, rules)
    else:       # one trace at full depth
        cost = count_cell(fn, args, in_sh, mesh, rules)
    t_compile = time.time() - t0 - t_lower
    mem = {"temp_size_in_bytes": int(cost["temp"]),
           "argument_size_in_bytes": per_device_bytes(args, in_sh),
           "output_size_in_bytes": output_bytes(meta["out_structs"],
                                                out_sh)}
    coll = {k[5:]: int(v) for k, v in cost.items() if k.startswith("coll_")}
    terms = rl.RooflineTerms(
        flops=cost["flops"], bytes_accessed=cost["bytes"], coll_bytes=coll,
        n_devices=n_dev, model_flops=_model_flops(cfg, shape))
    fallbacks = {k: {"count": round(cost[f"fb_{k}"]),
                     "bytes": int(cost[f"fb_{k}_bytes"])} for k in FALLBACKS}
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "n_devices": n_dev, "remat": remat,
        "rules": "custom" if rules else "default",
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory_analysis": _mem_dict(mem),
        **terms.to_dict(),
        "fallbacks": fallbacks, "torch": torch.__version__,
        "ok": True,
    }
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {mesh_kind}"
              f" ({n_dev} devices)")
        print(f"  build {t_lower:.1f}s trace {t_compile:.1f}s")
        print(f"  memory (per device): {rec['memory_analysis']}")
        print(f"  counted: flops/dev={terms.flops:.3e} "
              f"bytes/dev={terms.bytes_accessed:.3e}")
        print(f"  collectives/dev: "
              f"{ {k: f'{v:.3e}' for k, v in coll.items() if v} }")
        print(f"  fallbacks: {fmt_fallbacks(fallbacks)}")
        print(f"  roofline (H100): compute={terms.compute_s*1e3:.2f}ms "
              f"memory={terms.memory_s*1e3:.2f}ms "
              f"collective={terms.collective_s*1e3:.2f}ms "
              f"dominant={terms.dominant} "
              f"useful={terms.useful_ratio:.2f} "
              f"fraction={terms.roofline_fraction:.3f}")
    return rec


def _mem_dict(mem) -> Dict:
    """The reference's `memory_analysis()` keys the port has (no
    generated code: nothing is compiled)."""
    return {k: int(v) for k, v in mem.items() if v is not None}


def iter_cells():
    for arch, cfg in all_configs().items():
        for shape in cfg.runnable_shapes():
            yield arch, shape.name


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--all-shapes-for-arch", action="store_true")
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none"])
    ap.add_argument("--rules", default="default",
                    choices=["default", "seq_shard"],
                    help="seq_shard: Megatron-SP residual stream "
                         "(seq over model between blocks)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = list(iter_cells())
    elif args.all_shapes_for_arch:
        cells = [(args.arch, s.name)
                 for s in get_config(args.arch).runnable_shapes()]
    else:
        cells = [(args.arch, args.shape)]

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("remat", "full"))
            for r in results if r.get("ok")}

    for arch, shape in cells:
        for mk in meshes:
            key = (arch, shape, mk, args.remat)
            if key in done:
                print(f"[skip cached] {key}")
                continue
            try:
                rules = (make_rules(seq="model", embed_act=None)
                         if args.rules == "seq_shard" else None)
                rec = run_cell(arch, shape, mk, remat=args.remat,
                               rules=rules)
            except Exception as e:                     # noqa: BLE001
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "mesh": mk,
                       "remat": args.remat, "ok": False, "error": repr(e)}
            results.append(rec)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"[dryrun] {n_ok}/{len(results)} cells OK")
    if any(not r.get("ok") for r in results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
