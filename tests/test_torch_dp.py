"""Data-parallel training of the PyTorch port on the CPU against the JAX
reference: `make_manual_dp_step` (uncompressed and with the int8
gradient all-reduce), `grad_compress` and the launcher's `--manual-dp`
/ `--grad-compress`, mirroring `test_sharded.py::
test_manual_dp_step_with_compression` and `test_training.py::
test_int8_quantize_roundtrip`.

The reference runs in one module-scoped subprocess with two forced host
devices (`--xla_force_host_platform_device_count=2`): from one fp32 init
of the reduced qwen2-1.5b (scans unrolled: its fp32 forward needs it, see
`test_torch_models.py`) it takes one plain step and one 2-device manual
data-parallel step each way. The port runs a `gloo` world of two, two
processes rendezvoused through a `FileStore` under `tmp_path`, from the
reference's weights. Tolerances (the fp32 bounds of
`test_torch_training.py`): loss 1e-4 relative, every parameter leaf
1e-2 relative norm after one step. Compressed: a dequantized value
within one quantum (scale·1.01), the bias of 50 draws under 0.1·scale,
the loss within 0.05 of the plain step's. The port's rounding noise comes from a `torch.Generator` and
cannot reproduce JAX's threefry bits, so compression is held by these
bounds, not bit for bit. In a world of one the data-parallel step equals
the plain step bit for bit.
"""
import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch.mesh import dp_group, make_local_mesh, make_mesh
from repro_torch.models.registry import build_model
from repro_torch.training import grad_compress as gc
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (init_train_state,
                                             make_manual_dp_step,
                                             make_train_step)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, S = 8, 32
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)

REFERENCE = r"""
import os, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import make_local_mesh
from repro.models import common as rcm
from repro.models.registry import build_model
from repro.training.optimizer import AdamWConfig
from repro.training.train_step import (init_train_state,
                                       make_manual_dp_step, make_train_step)
out = sys.argv[1]
rcm.set_unroll_scans(True)
cfg = get_config("qwen2-1.5b").reduced()
model = build_model(cfg)
opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
mesh = make_local_mesh()
assert mesh.shape["data"] == 2, mesh.shape
B, S = 8, 32
tokens = (jnp.arange(B * S).reshape(B, S) % cfg.vocab).astype(jnp.int32)
batch = {"tokens": tokens, "labels": tokens}
state0 = init_train_state(model, jax.random.key(0), opt, jnp.float32)
arrs = {"tokens": np.asarray(tokens)}
arrs.update({f"p0/{k}": np.asarray(v) for k, v in state0["params"].items()})
st, m = jax.jit(make_train_step(model, opt, remat="none"))(state0, batch)
arrs["loss/plain"] = np.asarray(m["loss"])
arrs.update({f"plain/{k}": np.asarray(v) for k, v in st["params"].items()})
for compress in (False, True):
    # jitted: the eager shard_map of the unrolled model takes minutes
    step = jax.jit(make_manual_dp_step(model, opt, mesh, remat="none",
                                       compress=compress))
    st, m = step(state0, batch, jax.random.key(1))
    arrs[f"loss/dp{int(compress)}"] = np.asarray(m["loss"])
    arrs.update({f"dp{int(compress)}/{k}": np.asarray(v)
                 for k, v in st["params"].items()})
np.savez(os.path.join(out, "ref.npz"), **arrs)
print("OK")
"""

# one rank of the port's gloo world: the step both ways from the
# reference's weights, then compressed reductions against exact means
WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
rank, world = int(sys.argv[1]), int(sys.argv[2])
store, inp, out = sys.argv[3:6]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
try:
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import dp_group, make_local_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.training import grad_compress as gc
    from repro_torch.training.convert import state_from_numpy
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (_loss_and_grads,
                                                 make_manual_dp_step)
    d = np.load(inp)
    p0 = {k[3:]: d[k] for k in d.files if k.startswith("p0/")}
    tokens = torch.from_numpy(d["tokens"])
    batch = {"tokens": tokens, "labels": tokens}
    model = build_model(get_config("qwen2-1.5b").reduced())
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    res = {}
    with dp_group("cpu"):                       # the group made above
        mesh = make_local_mesh()
        res["mesh"] = np.asarray(mesh.size)
        for compress in (False, True):
            st = state_from_numpy(p0, "cpu")
            step = make_manual_dp_step(model, opt, mesh, remat="none",
                                       compress=compress)
            st, m = step(st, batch, 1)
            res[f"loss/dp{int(compress)}"] = m["loss"].numpy()
            for k, v in st["params"].items():
                res[f"dp{int(compress)}/{k}"] = v.numpy()
        # the compressed mean of this rank's gradients against the exact
        # one, leaf by leaf, with each leaf's agreed scale
        lo, hi = rank * 4, rank * 4 + 4
        _, g = _loss_and_grads(model, state_from_numpy(p0, "cpu")["params"],
                               {k: v[lo:hi] for k, v in batch.items()},
                               "none")
        comp = gc.compress_tree_psum({k: v.clone() for k, v in g.items()},
                                     seed=7)
        for k, v in g.items():
            exact = v.clone()
            dist.all_reduce(exact)
            amax = v.abs().max().clamp_min(1e-12)
            dist.all_reduce(amax, op=dist.ReduceOp.MAX)
            res[f"gerr/{k}"] = ((comp[k] - exact / world).abs().max()
                                / (amax / 127)).numpy()
        x = torch.from_numpy(np.random.default_rng(rank).standard_normal(
            1000).astype(np.float32) * (rank + 1))
        exact = x.clone()
        dist.all_reduce(exact)
        amax = x.abs().max()
        dist.all_reduce(amax, op=dist.ReduceOp.MAX)
        got = gc.compressed_psum(x, gc.leaf_generator(5, 0, "cpu"))
        res["psum_err_over_scale"] = ((got - exact / world).abs().max()
                                      / (amax / 127)).numpy()
    np.savez(out, **res)
finally:
    dist.destroy_process_group()
"""


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    run = subprocess.run([sys.executable, "-c", REFERENCE, str(out)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(out / "ref.npz")), out


@pytest.fixture(scope="module")
def ranks(ref):
    """The port's gloo world of two on the reference's weights: one
    result dict a rank."""
    out = ref[1]
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "2", str(out / "store"),
         str(out / "ref.npz"), str(out / f"rank{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(2)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            errs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, err in errs:
        assert rc == 0, err[-4000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def _rel(want: np.ndarray, got: np.ndarray) -> float:
    want = want.astype(np.float64)
    return float(np.linalg.norm(got.astype(np.float64) - want)
                 / np.linalg.norm(want))


def _leaves(d: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in d.items()
            if k.startswith(prefix + "/")}


def test_manual_dp_step_matches_reference_two_ranks(ref, ranks):
    r = ref[0]
    got = ranks[0]
    assert int(got["mesh"]) == 2
    want_loss = float(r["loss/dp0"])
    assert abs(float(got["loss/dp0"]) - want_loss) <= 1e-4 * abs(want_loss)
    want = _leaves(r, "dp0")
    mine = _leaves(got, "dp0")
    assert set(mine) == set(want)
    rel = {k: _rel(want[k], mine[k]) for k in want}
    loss_rel = abs(float(got["loss/dp0"]) - want_loss) / abs(want_loss)
    print(f"dp step, 2 ranks: loss {loss_rel:.3e}, params "
          f"{max(rel.values()):.3e} ({max(rel, key=rel.get)})")
    assert max(rel.values()) <= 1e-2, rel


def test_manual_dp_ranks_hold_equal_state(ranks):
    for prefix in ("dp0", "dp1"):
        a, b = _leaves(ranks[0], prefix), _leaves(ranks[1], prefix)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert float(ranks[0]["loss/dp1"]) == float(ranks[1]["loss/dp1"])


def test_manual_dp_step_with_compression(ref, ranks):
    r = ref[0]
    plain = float(r["loss/plain"])
    for got in ranks:
        assert abs(float(got["loss/dp1"]) - plain) < 0.05
        assert abs(float(got["loss/dp0"]) - plain) < 0.05
        p0 = _leaves(r, "p0")
        comp = _leaves(got, "dp1")
        assert all(np.isfinite(v).all() for v in comp.values())
        assert any(not np.array_equal(comp[k], p0[k]) for k in p0)
    assert abs(float(r["loss/dp1"]) - plain) < 0.05


def test_compressed_psum_within_one_quantum(ranks):
    for got in ranks:
        assert float(got["psum_err_over_scale"]) <= 1.01
        errs = _leaves(got, "gerr")
        print(f"compressed mean over the quantum: psum "
              f"{float(got['psum_err_over_scale']):.3f}, gradient leaves "
              f"{max(float(v) for v in errs.values()):.3f}")
        assert errs and max(float(v) for v in errs.values()) <= 1.01, errs


def test_int8_quantize_roundtrip():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1000, generator=gen) * 3.0
    q, s = gc.quantize_int8(x, torch.Generator().manual_seed(0))
    assert q.dtype == torch.int8
    err = (gc.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 1.01      # within one quantum
    # stochastic rounding is unbiased: the mean of 50 draws lands close
    outs = [gc.dequantize_int8(*gc.quantize_int8(
        x, torch.Generator().manual_seed(i))) for i in range(50)]
    bias = float((torch.stack(outs).mean(0) - x).abs().mean())
    assert bias < float(s) * 0.1


def test_compress_tree_psum_draws_one_generator_a_leaf():
    g = {"b": torch.randn(64), "a": torch.randn(3, 5)}
    one = gc.compress_tree_psum(g, seed=3)
    assert list(one) == ["a", "b"]                   # sorted-key order
    again = gc.compress_tree_psum(g, seed=3)
    other = gc.compress_tree_psum(g, seed=4)
    for k in g:
        assert torch.equal(one[k], again[k])
        assert one[k].dtype == g[k].dtype
        assert float((one[k] - g[k]).abs().max()) <= float(
            g[k].abs().max()) / 127 * 1.01
    assert any(not torch.equal(one[k], other[k]) for k in g)


@pytest.mark.parametrize("group", [False, True], ids=["no_group", "gloo"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_world_of_one_dp_step_equals_plain_step(group, dtype):
    """A data-parallel step over a world of one is the plain step, bit
    for bit, with or without a process group."""
    model = build_model(get_config("qwen2-1.5b").reduced())
    opt = AdamWConfig(**OPT)
    tokens = (torch.arange(B * S).reshape(B, S) % 512).to(torch.int32)
    batch = {"tokens": tokens, "labels": tokens}

    def fresh():
        return init_train_state(model, torch.Generator().manual_seed(0),
                                opt, dtype)

    plain, pm = make_train_step(model, opt, remat="none")(fresh(), batch)
    with dp_group("cpu") if group else contextlib.nullcontext():
        assert dist.is_initialized() == group
        step = make_manual_dp_step(model, opt, make_local_mesh(),
                                   remat="none", compress=False)
        dp, dm = step(fresh(), batch, 0)
    assert not dist.is_initialized()
    assert torch.equal(pm["loss"], dm["loss"])
    for k in plain["params"]:
        assert torch.equal(plain["params"][k], dp["params"][k]), k
        assert torch.equal(plain["opt"]["v"][k], dp["opt"]["v"][k]), k


def test_dp_step_rejects_a_mesh_that_is_not_the_world():
    model = build_model(get_config("qwen2-1.5b").reduced())
    with pytest.raises(ValueError, match="world of 1"):
        make_manual_dp_step(model, AdamWConfig(**OPT),
                            make_mesh((2, 1), ("data", "model"),
                                      ["cpu"] * 2))


def test_launcher_manual_dp_grad_compress(tmp_path, capsys):
    from repro_torch.launch import train
    common = ["--device", "cpu", "--reduced", "--batch", "2", "--seq", "32",
              "--reads", "200", "--block", "4096", "--prefetch", "0",
              "--ckpt-dir", str(tmp_path / "ck")]
    train.main(common + ["--steps", "2", "--manual-dp", "--grad-compress"])
    out = capsys.readouterr().out
    assert "data-parallel over 1 rank(s) (grad_compress=True)" in out
    assert "training complete; 2" in out
    assert not dist.is_initialized()              # the group was torn down
    with pytest.raises(SystemExit, match="--unroll"):
        train.main(common + ["--manual-dp", "--unroll", "2"])
