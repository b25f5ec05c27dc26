"""The dry-run's train cells on a mesh of three dims ("pod", "data",
"model"), traced to their end with their placements counted.

DTensor 2.13 places a view that flattens dims sharded on different mesh
dims (the mLSTM's (B, H) batch of its chunk products with B on ("pod",
"data") and H on "model"; `_mm`'s (B, S, E) → (B·S, E) with S on
"model") as a `_StridedShard`, and plans every redistribution of one by
a graph search. On a 3-D mesh that search outlasted the trace:
xlstm-350m × train_4k × multi never finished. On a mesh of three or more
dims `CostMode` runs such a flatten on the shards before DTensor sees it
and splits its rows back where a view restores the flattened sizes
(`launch/dryrun.py::_flatten_local`, `_unflatten_local`); there it also
scatters a product's partial sums first (`_scatter_partials`) and moves
the operands of an elementwise op without a strategy to one placement.
A 2-D mesh keeps DTensor's own route.

Readings, reduced train cells at depth 1, B=8 × T=64, one thread, each
trace alone, PyTorch 2.13 on the CPU:
- xLSTM (`xlstm-350m.reduced()`, one group, chunk 16): (4, 2) 42–49 s,
  FLOPs 1.763e9 a rank, 134 replicate and 67 whole fallbacks; (2, 2, 2)
  84 s, 6.081e8 FLOPs, 126 replicate (the sLSTM's `unbind` of gates
  whose gate axis "model" shards at this width), none whole. Without
  the 3-D route the (2, 2, 2) trace did not finish in 420 s. The (4, 2) twin
  reads 4.0× the model FLOPs: DTensor multiplies the mLSTM projections'
  backward gradients there while they are partial sums over both mesh
  dims, every rank the whole of them (1.0e9 of its FLOPs); on (2, 2, 2)
  `CostMode` scatters such sums before the product and the trace reads
  1.38×. So xLSTM is held against the model FLOPs and to at most the
  twin's, not to within 0.8× of the twin's.
- dense (`qwen2-1.5b.reduced()`, one layer): (4, 2) 16 s, (2, 2, 2)
  39–41 s, both 1.049e8 FLOPs a rank; no fallback but "flatten" (24) on
  (2, 2, 2). Without the 3-D route it did not finish in 170 s.
On the H100 host's PyTorch 2.11: xLSTM (4, 2) 18.7 s, (2, 2, 2) 19.3 s,
FLOPs 1.590e9 and 6.341e8, replicate and whole 544 and 128; dense 7.7 s
and 10.8 s, 1.049e8 both.
"""
import dataclasses as dc
import json
import pathlib
import subprocess
import sys
import time

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.xlstm import slstm_scan
from repro_torch.roofline import hlo_costs as rl

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE = ShapeConfig("tiny", 64, 8, "train")
MESHES = {2: ((4, 2), ("data", "model")),
          3: ((2, 2, 2), ("pod", "data", "model"))}
GUARD = 4.0           # the 3-D trace is killed at this many twin walls,
GUARD_CAP_S = 300.0   # capped here
# FLOPs a rank on (2, 2, 2): within (lowest, highest) of the (4, 2)
# twin's ("twin"), or, FLOPs x ranks, of the model FLOPs 6·N·D ("model",
# for xLSTM, whose twin multiplies whole partial sums); at most TWIN_MAX
# times the twin's in both
FLOPS_BAND = {"dense": ("twin", 0.8, 1.25), "xlstm": ("model", 1.0, 2.0)}
TWIN_MAX = 1.25


def reduced(case: str):
    if case == "xlstm":
        return dc.replace(get_config("xlstm-350m").reduced(), n_layers=4,
                          mlstm_chunk=16)
    return get_config("qwen2-1.5b").reduced()


def trace(case: str, ndim: int) -> dict:
    """One depth-1 trace of the case's reduced train cell on the 2-D or
    3-D mesh of 8 ranks (batch 4-way, heads 2-way in both): its
    `CostMode.metrics()` and "wall_s"."""
    cfg = reduced(case)
    mesh = make_mesh(*MESHES[ndim], ["meta"] * 8)
    t0 = time.perf_counter()
    m = dr._measure_cell(cfg, 1, SHAPE, mesh, "full", dr.rules_for(cfg),
                         dr._depth_cfg)
    return {**m, "wall_s": time.perf_counter() - t0}


def model_flops(case: str) -> float:
    cfg = dr._depth_cfg(reduced(case), 1)
    return rl.model_flops_train(cfg, SHAPE.global_batch * SHAPE.seq_len)


def hold(case: str, two: dict, three: dict) -> None:
    """The 3-D trace against its 2-D twin: FLOPs a rank within the case's
    FLOPS_BAND and at most TWIN_MAX times the twin's, no more replicate
    and whole fallbacks than the twin, positive FLOPs, bytes and `temp`
    in both."""
    for m in (two, three):
        assert m["flops"] > 0 and m["bytes"] > 0 and m["temp"] > 0, m
    of, lo, hi = FLOPS_BAND[case]
    ratio = three["flops"] / (two["flops"] if of == "twin"
                              else model_flops(case) / 8)
    assert lo <= ratio <= hi, (of, ratio)
    assert three["flops"] <= TWIN_MAX * two["flops"], (three, two)
    fell = {n: m["fb_replicate"] + m["fb_whole"]
            for n, m in (("2-D", two), ("3-D", three))}
    assert fell["3-D"] <= fell["2-D"], fell


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", ["xlstm", "dense"])
def test_multi_pod_trace_finishes_placed(case, tmp_path, capsys):
    """The reduced train cell traced on (4, 2) in process, then on
    (2, 2, 2) in a subprocess killed at GUARD times the twin's wall
    (capped at GUARD_CAP_S), so load on the machine moves the guard and
    the trace together and a regression fails instead of hanging."""
    two = trace(case, 2)
    guard = min(GUARD * two["wall_s"], GUARD_CAP_S)
    out = tmp_path / "three.json"
    paths = [str(ROOT / "src"), str(ROOT / "tests")]
    code = (f"import sys, json, torch; sys.path[:0] = {paths!r}; "
            "torch.set_num_threads(1); "
            "import test_torch_dryrun_multipod as t; "
            f"json.dump(t.trace({case!r}, 3), open({str(out)!r}, 'w'))")
    try:
        subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                       timeout=guard)
    except subprocess.TimeoutExpired:
        pytest.fail(f"{case}: the (2, 2, 2) trace passed its guard of "
                    f"{guard:.0f} s ({GUARD}x the (4, 2) twin's "
                    f"{two['wall_s']:.1f} s)")
    three = json.loads(out.read_text())
    with capsys.disabled():
        print(f"\n{case}: (4, 2) {two['wall_s']:.1f} s, (2, 2, 2) "
              f"{three['wall_s']:.1f} s; FLOPs {two['flops']:.4e} / "
              f"{three['flops']:.4e}; replicate+whole "
              f"{two['fb_replicate'] + two['fb_whole']:.0f} / "
              f"{three['fb_replicate'] + three['fb_whole']:.0f}")
    hold(case, two, three)


def _dtensor(mesh, dmesh, shape, spec, dtype=torch.float32):
    return dr._dtensors(torch.empty(shape, dtype=dtype, device="meta"),
                        (mesh, spec), dmesh)


def test_strided_flatten_runs_on_the_shards_on_a_3d_mesh():
    """(B, H, W, D) → (B·H, W, D) with B on ("pod", "data") and H on
    "model", a `bmm` and the split back to (B, H, W, W): on (2, 2, 2) the
    two flattens run on the shards ("flatten", no collective, no
    replicate), the output returns to B on ("pod", "data"), H on
    "model", and each rank counts its eighth of the product. On (4, 2)
    (B on "data") the same ops keep DTensor's route: the flattens are
    DTensor's where it places them (2.13), "flatten" only where it
    refuses them (2.11), and the split returns B on "data", H on
    "model"."""
    from torch.distributed.tensor import Shard
    B, H, W, D = 8, 4, 16, 32
    for ndim, batch in ((3, ("pod", "data")), (2, "data")):
        mesh = make_mesh(*MESHES[ndim], ["meta"] * 8)
        with dr.fake_world(8):
            dmesh = dr.device_mesh(mesh)
            x, y = (_dtensor(mesh, dmesh, (B, H, W, D),
                             (batch, "model", None, None)) for _ in "xy")
            try:
                x.reshape(B * H, W, D)
                refused = False
            except RuntimeError:
                refused = True
            with dr._marking_propagation(), dr._alltoall_as_one(), \
                    dr.CostMode() as c:
                s = torch.bmm(x.reshape(B * H, W, D),
                              y.reshape(B * H, W, D).transpose(1, 2))
                out = s.view(B, H, W, W)
            want = (Shard(0),) * (ndim - 1) + (Shard(1),)
            assert tuple(out.placements) == want, (ndim, out.placements)
            assert out.to_local().shape == (B // 4, H // 2, W, W)
            if ndim == 3:
                assert c.fallbacks == {"flatten": {"count": 2, "bytes": 0}}
                assert c.collectives == []
                assert c.flops == 2 * (B * H // 8) * W * D * W
            else:
                assert ("flatten" in c.fallbacks) == refused, c.fallbacks
                assert "replicate" not in c.fallbacks
        assert not dist.is_initialized()


def test_slstm_step_keeps_its_placement_on_a_3d_mesh():
    """Two sLSTM steps of the reduced config (B=8, H=4, D=32) on (2, 2, 2),
    forward and backward. The gates reach `slstm_scan` as the mLSTM's
    products leave their rows: flattened to (B·H, ...) with B on ("pod",
    "data") and H on "model", cast, through a `bmm` and a transpose, split
    back and permuted to (B, T, 4, H, D). They keep B on ("pod", "data")
    and H on "model", and so do the cell's output and the gates'
    gradient. No op falls back to a collective: the forward counts the
    two flattens only, and the backward adds the one op DTensor has no
    strategy for, `log_sigmoid_backward`, run on its shards as they lie
    ("local", no bytes moved)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = reduced("xlstm")
    B, T, H = 8, 2, cfg.n_heads
    D = cfg.d_model // H
    mesh = make_mesh(*MESHES[3], ["meta"] * 8)
    with dr.fake_world(8):
        dmesh = dr.device_mesh(mesh)
        pre = _dtensor(mesh, dmesh, (B, H, T * 4, D),
                       (("pod", "data"), "model", None, None), torch.bfloat16)
        mix = _dtensor(mesh, dmesh, (B, H, D, D),
                       (("pod", "data"), "model", None, None))
        rw = _dtensor(mesh, dmesh, (4, H, D, D), (None, "model", None, None))
        for t in (pre, mix, rw):
            t.requires_grad_()
        with implicit_replication(), dr._marking_propagation(), \
                dr._alltoall_as_one(), dr.CostMode() as c:
            rows = torch.bmm(pre.reshape(B * H, T * 4, D).float(),
                             mix.reshape(B * H, D, D)).transpose(1, 2)
            gates = rows.transpose(1, 2).reshape(B, H, T, 4, D) \
                .permute(0, 2, 3, 1, 4)
            gates.retain_grad()
            h, _ = slstm_scan(gates, rw)
            forward = {k: dict(v) for k, v in c.fallbacks.items()}
            h.sum().backward()
        assert tuple(gates.placements) == (Shard(0), Shard(0), Shard(3))
        assert tuple(h.placements) == (Shard(0), Shard(0), Shard(2))
        assert tuple(gates.grad.placements) == tuple(gates.placements)
        assert forward == {"flatten": {"count": 2, "bytes": 0}}, forward
        back = {k: v for k, v in c.fallbacks.items() if k != "flatten"}
        assert set(back) <= {"local"}, c.fallbacks
        assert all(v["bytes"] == 0 for v in back.values()), back
    assert not dist.is_initialized()


@pytest.mark.parametrize("ndim", [2, 3])
def test_xlstm_sequence_fit_traces_further_chunks_on_a_3d_mesh(ndim,
                                                               monkeypatch):
    """xLSTM's train cell is fitted in depth and in sequence length from
    four traces: at 2 and 4 mLSTM chunks on a 2-D mesh, at 4 and 8 on a
    3-D one (where DTensor places a group's products otherwise at 2
    chunks than at 4). A cost linear in both comes back exact at the
    cell's full depth and length."""
    cfg, seen = reduced("xlstm"), []

    def measure(cfg_, d, shape, *_):
        seen.append((d, shape.seq_len))
        return {"flops": 3.0 + 5.0 * shape.seq_len
                + d * (7.0 + 11.0 * shape.seq_len)}

    monkeypatch.setattr(dr, "_measure_cell", measure)
    mesh = make_mesh(*MESHES[ndim], ["meta"] * 8)
    out = dr.cost_extrapolated(cfg, SHAPE, mesh, "full")
    k = 2 if ndim == 2 else 4
    W = cfg.mlstm_chunk
    assert sorted(set(seen)) == [(1, k * W), (1, 2 * k * W),
                                 (2, k * W), (2, 2 * k * W)]
    units, S = cfg.n_layers // cfg.slstm_every, SHAPE.seq_len
    assert out["flops"] == pytest.approx(3.0 + 5.0 * S
                                         + units * (7.0 + 11.0 * S))
