"""The port's dry-run (`repro_torch.launch.dryrun`) against the JAX
package's. The reference's `launch/dryrun.py` forces 512 XLA host
devices when it is imported, so it runs once in a module-scoped
subprocess that writes, as JSON under `tmp_path`: every `(arch, runnable
shape)` cell's argument structs and sanitised specs on both production
meshes, and `memory_analysis()`/`cost_analysis()`/collectives of two
small cells compiled on a (4, 2) mesh.

Held exactly: structs, dtypes and specs of every cell; per-device
argument bytes, and output bytes plus the 8-byte index XLA keeps for
each leaf of a tuple output; the counted FLOPs of a reduced dense
prefill against the closed form 2·M·K·N summed over its products (per
device on a mesh, globally on plain tensors); a depth-3 count against
the fit of depths 1 and 2. Not equal by design, and only checked for
sign: FLOPs (XLA also counts elementwise ops), bytes (fused against
eager) and collective kinds (DTensor's choices, not XLA's)."""
import dataclasses as dc
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_mesh, make_production_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]

REF = r'''
import json, sys, dataclasses as dc
from repro.launch import dryrun as D      # forces 512 host devices first
from repro.launch.mesh import make_production_mesh
from repro.compat import cost_analysis, make_mesh, mesh_context
from repro.configs import get_config
from repro.roofline import hlo_costs as rl
import jax


def walk(structs, shardings, prefix, out):
    if isinstance(structs, dict):
        for k in structs:
            walk(structs[k], shardings[k], f"{prefix}/{k}", out)
    elif isinstance(structs, (tuple, list)):
        for i, (s, h) in enumerate(zip(structs, shardings)):
            walk(s, h, f"{prefix}/{i}", out)
    else:
        out[prefix] = [list(structs.shape), str(structs.dtype),
                       [list(e) if isinstance(e, tuple) else e
                        for e in shardings.spec]]


cells = {}
for kind in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=kind == "multi")
    for arch, shape in D.iter_cells():
        _, args, in_sh, _, _, _ = D.build_cell(arch, shape, mesh)
        out = {}
        walk(args, in_sh, "", out)
        cells[f"{arch}|{shape}|{kind}"] = out
small = {}
mesh = make_mesh((4, 2), ("data", "model"))
cfg = dc.replace(get_config("qwen2-1.5b").reduced(), n_layers=2)
D.SHAPES_BY_NAME["tiny_train"] = D.ShapeConfig("tiny_train", 64, 8, "train")
for shape in ("tiny_train", "decode_32k"):
    fn, args, in_sh, out_sh, donate, meta = D.build_cell(cfg, shape, mesh)
    with mesh_context(mesh):
        compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                           donate_argnums=donate).lower(*args).compile()
    mem = compiled.memory_analysis()
    cost = cost_analysis(compiled)
    small[shape] = {
        "argument_size_in_bytes": int(mem.argument_size_in_bytes),
        "output_size_in_bytes": int(mem.output_size_in_bytes),
        "temp_size_in_bytes": int(mem.temp_size_in_bytes),
        "flops": float(cost.get("flops", 0.0)),
        "bytes": float(cost.get("bytes accessed", 0.0)),
        "coll": rl.collective_bytes(compiled.as_text())}
with open(sys.argv[1], "w") as f:
    json.dump({"cells": cells, "small": small}, f)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_ref")
    (d / "ref.py").write_text(REF)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    subprocess.run([sys.executable, str(d / "ref.py"), str(d / "ref.json")],
                   check=True, cwd=ROOT, env=env, timeout=600)
    return json.loads((d / "ref.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(structs, shardings, prefix, out):
    if isinstance(structs, dict):
        for k in structs:
            _walk(structs[k], shardings[k], f"{prefix}/{k}", out)
    elif isinstance(structs, (tuple, list)):
        for i, (s, h) in enumerate(zip(structs, shardings)):
            _walk(s, h, f"{prefix}/{i}", out)
    else:
        out[prefix] = [list(structs.shape),
                       str(structs.dtype).replace("torch.", ""),
                       [list(e) if isinstance(e, tuple) else e
                        for e in shardings[1]]]


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_cell_structs_and_specs_match_reference(ref, kind):
    mesh = make_production_mesh(multi_pod=kind == "multi")
    cells = list(dr.iter_cells())
    assert len(cells) == 32
    for arch, shape in cells:
        _, args, in_sh, _, _, _ = dr.build_cell(arch, shape, mesh)
        got = {}
        _walk(args, in_sh, "", got)
        want = ref["cells"][f"{arch}|{shape}|{kind}"]
        assert got == want, (arch, shape, kind)


TINY_TRAIN = ShapeConfig("tiny_train", 64, 8, "train")


def _small(shape):
    mesh = make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
    cfg = dc.replace(get_config("qwen2-1.5b").reduced(), n_layers=2)
    return mesh, cfg, dr.build_cell(
        cfg, TINY_TRAIN if shape == "tiny_train" else shape, mesh)


@pytest.mark.parametrize("shape", ["tiny_train", "decode_32k"])
def test_argument_and_output_bytes_match_compiled_reference(ref, shape):
    _, _, (_, args, in_sh, out_sh, _, meta) = _small(shape)
    want = ref["small"][shape]
    assert dr.per_device_bytes(args, in_sh) == want["argument_size_in_bytes"]
    assert dr.output_bytes(meta["out_structs"], out_sh) \
        == want["output_size_in_bytes"]


def test_train_cell_counts_flops_and_collectives(ref, capsys):
    """The reference's own assertion (tests/test_sharded.py): FLOPs and
    collective bytes of a train cell are positive. The ratios to the
    compiled reference, and both `temp`s (the port's peak of live bytes,
    XLA's buffer assignment), are printed: they differ by design, so the
    all-to-all and all-gather bytes and `temp` are held only within a
    stated factor of the reference's."""
    mesh, cfg, (fn, args, in_sh, _, _, _) = _small("tiny_train")
    m = dr.count_cell(fn, args, in_sh, mesh, dr.rules_for(cfg))
    assert not dist.is_initialized()
    coll = {k[5:]: v for k, v in m.items() if k.startswith("coll_")}
    assert m["flops"] > 0 and m["bytes"] > 0 and sum(coll.values()) > 0
    assert m["temp"] > 0
    want = ref["small"]["tiny_train"]
    # kinds both count, held to the reference's scale: the port / XLA
    # readings on 2.13 are all-to-all 1.06 (0 before each Shard(i) ->
    # Shard(j) move counted as one), all-gather 1.27 (2.03 when the
    # "cpu" group's all-gather stand-in was counted) and temp 0.51
    # (eager peak of live bytes against XLA's buffer assignment)
    for kind, (lo, hi) in {"all-to-all": (0.5, 2.0),
                           "all-gather": (0.5, 1.6)}.items():
        if want["coll"].get(kind, 0) > 0:
            assert lo <= coll.get(kind, 0) / want["coll"][kind] <= hi, kind
    assert 0.25 <= m["temp"] / want["temp_size_in_bytes"] <= 4.0
    with capsys.disabled():
        print("\nport/reference, reduced qwen2 B=8 T=64 train on (4, 2): "
              f"flops "
              f"{m['flops'] / want['flops']:.3f}, bytes "
              f"{m['bytes'] / want['bytes']:.3f}, temp "
              f"{m['temp']:.0f} B against {want['temp_size_in_bytes']} B, "
              f"collectives "
              f"{ {k: (coll[k], want['coll'][k]) for k in coll} }")


def _closed_form(cfg, B, S):
    E, Q, KV, F, V = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff, cfg.vocab
    per_layer = 2 * B * S * (E * Q + 2 * E * KV + Q * E + 3 * E * F)
    attention = 2 * (2 * B * cfg.n_heads * S * S * cfg.head_dim)
    return cfg.n_layers * (per_layer + attention) + 2 * B * S * E * V


@pytest.mark.parametrize("mesh_shape", [(4, 2)])
def test_counted_flops_equal_the_closed_form(mesh_shape):
    """A reduced dense prefill of one layer (B=8, S=64: one attention
    chunk): the per-device matmul FLOPs times the devices equal
    2·M·K·N summed over its products (q, k, v, o, the three MLP
    products, scores, PV, the unembedding)."""
    n = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, ("data", "model"), ["meta"] * n)
    cfg = dc.replace(get_config("qwen2-1.5b").reduced(), n_layers=1)
    shape = dc.replace(TINY_TRAIN, kind="prefill")
    fn, args, in_sh, _, _, _ = dr.build_cell(cfg, shape, mesh)
    m = dr.count_cell(fn, args, in_sh, mesh, dr.rules_for(cfg))
    assert m["flops"] * n == _closed_form(cfg, 8, 64)


def test_plain_tensors_count_the_closed_form_globally():
    cfg = dc.replace(get_config("qwen2-1.5b").reduced(), n_layers=2)
    from repro_torch.models import common as cm
    from repro_torch.models.registry import build_model
    model = build_model(cfg)
    params = cm.param_structs(model.param_defs())
    tokens = cm.meta((8, 64), torch.int32)
    with dr.CostMode() as c:
        model.forward(params, tokens, remat="none")
    assert c.flops == _closed_form(cfg, 8, 64)
    assert c.collectives == [] and c.bytes > 0


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_depth_fit_equals_a_direct_count(kind):
    """Fitted from depths 1 and 2, every counted metric but the live-bytes
    estimate equals a direct count at depth 3 (the dense family is linear
    in depth)."""
    mesh = make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
    cfg = dc.replace(get_config("qwen2-1.5b").reduced(), n_layers=3)
    shape = dc.replace(TINY_TRAIN, kind=kind)
    rules = dr.rules_for(cfg)
    fit = dr.cost_extrapolated(cfg, shape, mesh, "full", rules)
    fn, args, in_sh, _, _, _ = dr.build_cell(cfg, shape, mesh, rules=rules)
    direct = dr.count_cell(fn, args, in_sh, mesh, rules)
    for k in direct:
        if k == "temp":
            assert fit[k] == pytest.approx(direct[k], rel=0.5), k
        else:
            assert fit[k] == direct[k], k


def test_decode_cache_write_runs_on_its_own_shard():
    """The decode step writes each layer's KV cache (kv_seq sharded over
    "model") in place. As XLA's partitioned dynamic_update_slice writes
    only on the owning shard, the count gathers no cache: every write is
    a "local" fallback of no collective bytes, and the step's all-gathers
    stay below one layer's local K cache."""
    mesh, cfg, (fn, args, in_sh, _, _, _) = _small("decode_32k")
    cache = args[1]["k"]
    local_layer = (cache[0].numel() * cache.element_size()
                   // (mesh.shape["data"] * mesh.shape["model"]))
    m = dr.count_cell(fn, args, in_sh, mesh, dr.rules_for(cfg))
    assert m["fb_local"] == 2 * cfg.n_layers and m["fb_local_bytes"] == 0
    assert m["fb_whole"] == 0
    assert 0 < m["coll_all-gather"] < local_layer


def test_dense_train_flops_stay_near_the_model_flops():
    """Counted per-device FLOPs of a reduced dense train cell on the
    (4, 2) mesh, times the devices, lie within 1.0-2.0x the model FLOPs
    6·N·D: remat "full" recomputes the forward (8/6) and attention adds
    its products; products run replicated by fallbacks would push it
    past 2 (8x if every product ran whole on each device)."""
    from repro_torch.roofline import hlo_costs as rl
    mesh, cfg, (fn, args, in_sh, _, _, _) = _small("tiny_train")
    m = dr.count_cell(fn, args, in_sh, mesh, dr.rules_for(cfg))
    ratio = m["flops"] * mesh.size / rl.model_flops_train(cfg, 8 * 64)
    assert 1.0 <= ratio <= 2.0, ratio


# DTensor 2.11 (the card's host) refuses a strict view that flattens a
# sharded dim other than the first of its group; 2.13 places it as a
# _StridedShard. The refusal is raised here as 2.11 raises it: from
# DTensor's view rules, which is where `_unplaceable` looks for it.
_REFUSE_211 = """
def _analyze_flatten(self, cmd):
    for i, dim in enumerate(cmd.input_dims):
        if i > 0 and self.strict_view \\
                and self._find_plain_shard(dim)[0] is not None:
            raise RuntimeError(
                f"Attempted to flatten multiple dimensions, with dimension "
                f"{dim.input_dim} being sharded. It cannot be performed "
                f"without redistribution, which is disallowed by the "
                f"current operator.")
    return _own(self, cmd)
"""


def refuse_flatten_as_2_11(monkeypatch):
    """Make this DTensor refuse such flattens until `monkeypatch` undoes
    it (its cached placements dropped, which would skip the refusal). A
    DTensor without `_ViewShardingPropagator` (2.11's) refuses them
    itself."""
    from torch.distributed.tensor._ops import _view_ops as V
    if not hasattr(V, "_ViewShardingPropagator"):
        return
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache
    ns = {"_own": V._ViewShardingPropagator._analyze_flatten}
    exec(compile(_REFUSE_211, V.__file__, "exec"), ns)
    _clear_sharding_prop_cache()
    monkeypatch.setattr(V._ViewShardingPropagator, "_analyze_flatten",
                        ns["_analyze_flatten"])


def test_flatten_refused_as_on_2_11_counts_as_placed(monkeypatch):
    """Where DTensor refuses `_mm`'s and attention's flattens of a batch
    on "data" and a sequence on "model" (2.11), CostMode runs them on the
    shards ("flatten") and splits them back there: the reduced train cell
    counts the FLOPs that a DTensor placing them itself (2.13) counts,
    with no replicate fallback, within 1.0-2.0x the model FLOPs."""
    from repro_torch.roofline import hlo_costs as rl
    mesh, cfg, (fn, args, in_sh, _, _, _) = _small("tiny_train")
    placed = dr.count_cell(fn, args, in_sh, mesh, dr.rules_for(cfg))
    refuse_flatten_as_2_11(monkeypatch)
    m = dr.count_cell(fn, args, in_sh, mesh, dr.rules_for(cfg))
    assert m["fb_flatten"] > 0 and m["fb_flatten_bytes"] == 0
    assert m["fb_replicate"] == 0 and m["fb_whole"] == 0
    assert m["flops"] == placed["flops"]
    ratio = m["flops"] * mesh.size / rl.model_flops_train(cfg, 8 * 64)
    assert 1.0 <= ratio <= 2.0, ratio


def test_flatten_rule_splits_back_to_the_placement_it_came_from(
        monkeypatch):
    """A (B, S, E) activation, B on "data", S on "model", times a
    replicated (E, F) weight: the refused flatten runs on the shards and
    the product's (B·S, F) rows split back to B on "data", S on "model",
    every local shape a quarter of B and half of S, no collective."""
    from torch.distributed.tensor import Shard
    refuse_flatten_as_2_11(monkeypatch)
    mesh = make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
    with dr.fake_world(8):
        dmesh = dr.device_mesh(mesh)
        x = dr._dtensors(torch.empty(8, 64, 32, device="meta"),
                         (mesh, ("data", "model", None)), dmesh)
        w = dr._dtensors(torch.empty(32, 48, device="meta"),
                         (mesh, (None, None)), dmesh)
        with dr.CostMode() as c:
            y = torch.matmul(x, w)
        assert y.shape == (8, 64, 48)
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert y.to_local().shape == (2, 32, 48)
        assert c.fallbacks == {"flatten": {"count": 1, "bytes": 0}}
        assert c.collectives == [] and c.flops == 2 * 2 * 32 * 32 * 48
    assert not dist.is_initialized()


def test_flatten_rule_gathers_the_weight_not_the_sequence(monkeypatch):
    """Where the flatten is refused (2.11), the product of a (B, S, E)
    activation (B on "data", S on "model") by an (E, F) weight with F on
    "model" keeps its rows on both mesh dims and gathers the weight's
    "model" shards: one all-gather of the whole weight, none of the
    activation's sequence (which a DTensor placing the flatten as a
    strided shard, 2.13, gathers instead)."""
    from torch.distributed.tensor import Shard
    refuse_flatten_as_2_11(monkeypatch)
    mesh = make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
    with dr.fake_world(8):
        dmesh = dr.device_mesh(mesh)
        x = dr._dtensors(torch.empty(8, 64, 32, device="meta"),
                         (mesh, ("data", "model", None)), dmesh)
        w = dr._dtensors(torch.empty(32, 48, device="meta"),
                         (mesh, (None, "model")), dmesh)
        with dr._marking_propagation(), dr._alltoall_as_one(), \
                dr.CostMode() as c:
            y = torch.matmul(x, w)
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert c.collectives == [("all-gather", 32 * 48 * 4)]
    assert not dist.is_initialized()


def test_gather_backward_zeros_take_the_logits_placement():
    """The loss gathers the gold token's logit; its backward makes zeros
    of the logits' shape and scatters the gradient into them. On
    vocab-sharded logits of the (4, 2) mesh rank 0 holds its shard of
    those B·S·V zeros, never the whole, as XLA places them."""
    mesh = make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
    B, S, V = 8, 64, 512
    whole = B * S * V * 4
    with dr.fake_world(8):
        dmesh = dr.device_mesh(mesh)
        logits = dr._dtensors(torch.empty(B, S, V, device="meta"),
                              (mesh, ("data", None, "model")), dmesh)
        logits.requires_grad_()
        labels = dr._dtensors(torch.empty(B, S, 1, dtype=torch.int64,
                                          device="meta"),
                              (mesh, ("data", None, None)), dmesh)
        with dr._marking_propagation(), dr._alltoall_as_one(), \
                dr.CostMode() as c:
            gold = torch.gather(logits, -1, labels)
            gold.mean().backward()
            peak = c.peak_live
            # the backward took the gather's placement: zeros of the same
            # shape made after it are not the gather's
            other = gold.detach().new_zeros((B, S, V))
        assert logits.grad.shape == (B, S, V)
        assert 0 < peak < whole, (peak, whole)
        assert all(p.is_replicate() for p in other.placements)
    assert not dist.is_initialized()


def test_flatten_rule_keeps_rows_through_elementwise_ops(monkeypatch):
    """Between the refused flatten of a (B, S, E) activation (B on
    "data", S on "model") and the view that splits it back, a cast and
    elementwise ops keep the rows where the flatten put them: the split
    returns B on "data", S on "model", with no collective and no
    fallback but the flatten."""
    from torch.distributed.tensor import Shard
    refuse_flatten_as_2_11(monkeypatch)
    mesh = make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
    with dr.fake_world(8):
        dmesh = dr.device_mesh(mesh)
        x = dr._dtensors(torch.empty(8, 64, 32, device="meta"),
                         (mesh, ("data", "model", None)), dmesh)
        with dr.CostMode() as c:
            rows = x.view(8 * 64, 32)
            rows = torch.nn.functional.gelu(rows.to(torch.bfloat16) * 2.0)
            y = rows.view(8, 64, 32)
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert y.to_local().shape == (2, 32, 32)
        assert c.fallbacks == {"flatten": {"count": 1, "bytes": 0}}
        assert c.collectives == []
    assert not dist.is_initialized()


def test_shard_to_shard_move_is_one_all_to_all():
    """A Shard(0) → Shard(1) move on the "data" dim of a (4, 2) mesh is
    recorded as one all-to-all of the tensor's local bytes, as a card's
    group runs it, and not as the all-gather and chunk that stand in for
    it on a "cpu" group."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
    with dr.fake_world(8):
        dmesh = dr.device_mesh(mesh)
        t = dr._dtensors(torch.empty(8, 16, device="meta"),
                         (mesh, ("data", None)), dmesh)
        local = t.to_local().numel() * 4
        with dr._marking_propagation(), dr._alltoall_as_one(), \
                dr.CostMode() as c:
            u = t.redistribute(dmesh, [Shard(1), Replicate()])
        assert u.to_local().shape == (8, 4)
        assert c.collectives == [("all-to-all", local)]
    assert not dist.is_initialized()


def test_an_error_of_the_model_is_not_taken_for_a_placement():
    """CostMode falls back only where DTensor refuses a placement; a
    product of mismatched shapes fails the trace."""
    from torch.distributed.tensor import Shard
    mesh = make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
    with dr.fake_world(8):
        dmesh = dr.device_mesh(mesh)
        a = dr._dtensors(torch.empty(8, 6, device="meta"),
                         (mesh, ("data", None)), dmesh)
        b = dr._dtensors(torch.empty(5, 4, device="meta"),
                         (mesh, (None, "model")), dmesh)
        with pytest.raises(RuntimeError), dr.CostMode():
            torch.mm(a, b)
        assert isinstance(a.placements[0], Shard)
    assert not dist.is_initialized()


def test_elementwise_op_without_a_strategy_runs_on_its_shards():
    """`log_sigmoid_backward` (xLSTM's gates) has no DTensor sharding
    strategy; its operands share one placement, so it runs on the
    shards with no collective, its result placed as they are."""
    mesh = make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
    with dr.fake_world(8):
        dmesh = dr.device_mesh(mesh)
        g, x, buf = (dr._dtensors(torch.empty(8, 6, device="meta"),
                                  (mesh, ("data", "model")), dmesh)
                     for _ in range(3))
        with dr.CostMode() as c:
            out = torch.ops.aten.log_sigmoid_backward(g, x, buf)
        assert out.placements == x.placements and out.shape == x.shape
        assert c.fallbacks == {"local": {"count": 1, "bytes": 0}}
        assert c.collectives == []
    assert not dist.is_initialized()


def test_fake_world_leaves_no_process_group_and_refuses_one():
    assert not dist.is_initialized()
    with dr.fake_world(8):
        assert dist.is_initialized() and dist.get_world_size() == 8
    assert not dist.is_initialized()
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialised"):
            with dr.fake_world(8):
                pass
    finally:
        dist.destroy_process_group()


def test_main_writes_records_that_report_reads(tmp_path):
    out = tmp_path / "dryrun_q.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-1.5b", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(out)], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "[dryrun] 1/1 cells OK" in run.stdout
    recs = json.loads(out.read_text())
    (rec,) = recs
    assert rec["ok"] and rec["n_devices"] == 256
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.roofline.report", str(out)],
        capture_output=True, text=True, check=True, cwd=ROOT, env=env)
    assert "# 1/1 cells ok" in rep.stdout
    assert "| qwen2-1.5b | decode_32k | single | ✓ |" in rep.stdout
