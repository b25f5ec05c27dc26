"""The port's training substrate (AdamW, schedule, train steps) against the
JAX reference on the CPU, mirroring `tests/test_training.py` (its int8
gradient-compression test is mirrored in `tests/test_torch_dp.py`).

Tolerances (worst seen on these inputs in brackets; the reference's
init differs from process to process, since it keys each parameter by
Python's salted `hash(path)`, so the five-step readings are the worst
of nine processes, printed by the test under `pytest -s`):
  * `adamw_update`, fp32, one step from the same params, grads and
    moments: new params, moments and grad norm 1e-6 relative [~1e-7].
  * five `make_train_step` steps from the same carried state on the same
    batches: each loss 1e-4 relative in fp32 [1.8e-6], 2e-2 in bf16
    [4.3e-5]. Final params, by relative norm per leaf:
      - fp32: each leaf's update (final minus initial params) within
        1e-1 of the reference's [3.4e-2, embed], and its params within
        1e-2 [3.9e-3]. A leaf that never moved reads 1, one that moved
        the wrong way 2. The bound is not near 1e-5: AdamW's first
        updates are close to ±lr per element (m/√v ≈ sign(g)), so an
        element whose gradient is near zero can step the other way in
        the two packages.
      - bf16: each leaf's params within 2^-5 (four bf16 ulps at 2^-7)
        [1.5e-2, embed], and the update of all leaves as one vector
        within 0.15 of the reference's [5.6e-2]. A leaf's update is
        held only within that vector: five steps move a norm weight
        by about one ulp, so per leaf the update is mostly rounding
        [up to 0.94]. A state that never moved reads 1.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as r_get_config
from repro.models import common as rcm
from repro.models.registry import build_model as r_build
from repro.training import optimizer as ropt
from repro.training.train_step import init_train_state as r_init_state
from repro.training.train_step import make_train_step as r_make_step
from repro_torch.configs import get_config
from repro_torch.data.fastq import make_fastq
from repro_torch.data.pipeline import (CompressedResidentDataLoader,
                                       PipelineConfig)
from repro_torch.models.registry import build_model
from repro_torch.training.convert import state_from_numpy, state_to_numpy
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            global_norm, init_opt_state,
                                            lr_at)
from repro_torch.training.train_step import (init_train_state,
                                             make_manual_dp_step,
                                             make_train_step,
                                             make_unrolled_train_step)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lr_schedule():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in (0, 5, 10, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4, rel=1e-3)
    assert lrs[2] == pytest.approx(1e-3, rel=1e-3)
    assert lrs[3] == pytest.approx(1e-4, rel=1e-2)   # cosine floor 0.1×
    rcfg = ropt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 10, 37, 100, 140):
        assert float(lr_at(cfg, torch.tensor(s, dtype=torch.int32))) == \
            float(ropt.lr_at(rcfg, jnp.asarray(s, jnp.int32)))


def test_adamw_step_direction():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10,
                      weight_decay=0.0, clip_norm=1e9)
    params = {"w": torch.ones(4)}
    grads = {"w": torch.full((4,), 2.0)}
    opt = init_opt_state(params)
    new_p, new_opt, m = adamw_update(cfg, params, grads, opt)
    assert float(new_p["w"][0]) < 1.0            # moved against gradient
    assert int(new_opt["step"]) == 1
    assert new_opt["step"].dtype == torch.int32
    assert float(m["grad_norm"]) == pytest.approx(4.0)
    assert new_p["w"] is params["w"]             # updated in place
    assert new_opt["m"]["w"] is opt["m"]["w"]


def test_grad_clipping():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=0, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    grads = {"w": torch.full((3,), 1e6)}
    opt = init_opt_state(params)
    _, _, m = adamw_update(cfg, params, grads, opt)
    assert float(m["grad_norm"]) > 1e6           # reported raw


@pytest.mark.parametrize("start_step", [0, 4])
def test_adamw_update_matches_reference(start_step):
    rng = np.random.default_rng(0)
    shapes = {"layers/wq": (3, 16, 8), "final_norm": (16,), "embed": (32, 16),
              "layers/bq": (3, 8)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
         for k, s in shapes.items()}
    m = {k: (rng.standard_normal(s) * 0.01).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: np.abs(rng.standard_normal(s) * 1e-3).astype(np.float32)
         for k, s in shapes.items()}
    kw = dict(lr=3e-3, warmup_steps=3, total_steps=50, clip_norm=0.5)
    rp, ro, rm = ropt.adamw_update(
        ropt.AdamWConfig(**kw), {k: jnp.asarray(x) for k, x in p.items()},
        {k: jnp.asarray(x) for k, x in g.items()},
        {"m": {k: jnp.asarray(x) for k, x in m.items()},
         "v": {k: jnp.asarray(x) for k, x in v.items()},
         "step": jnp.asarray(start_step, jnp.int32)})
    st = state_from_numpy(p, "cpu", opt={"m": m, "v": v, "step": start_step})
    pp, po, pm = adamw_update(
        AdamWConfig(**kw), st["params"],
        {k: torch.from_numpy(x) for k, x in g.items()}, st["opt"])
    assert int(po["step"]) == int(ro["step"]) == start_step + 1
    assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-7)
    assert float(pm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                   rel=1e-6)
    for k in shapes:
        for want, got in ((rp[k], pp[k]), (ro["m"][k], po["m"][k]),
                          (ro["v"][k], po["v"][k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-9)
    # the given state now holds the new values
    assert all(st["params"][k] is pp[k] and st["opt"]["v"][k] is po["v"][k]
               for k in shapes)


def test_global_norm_is_fp32_sum_of_squares():
    tree = {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.full((4,), 2.)}
    assert float(global_norm(tree)) == pytest.approx(np.sqrt(3 + 16))


def _loader(seq, batch, n_reads=400, seed=3):
    return CompressedResidentDataLoader(
        make_fastq("platinum", n_reads=n_reads, seed=seed),
        PipelineConfig(seq_len=seq, batch_size=batch, block_size=4096),
        device="cpu")


def test_loss_decreases_on_real_pipeline():
    cfg = get_config("qwen2-1.5b").reduced()
    model = build_model(cfg)
    opt = AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=30)
    state = init_train_state(model, torch.Generator().manual_seed(0), opt)
    dl = _loader(64, 4)
    step = make_train_step(model, opt, remat="none")
    losses = []
    for i, batch in zip(range(20), dl):
        assert batch["tokens"].dtype == torch.int32
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    dl.close()
    assert losses[-1] < losses[0] * 0.8, losses


def test_unrolled_step_matches_per_step_losses():
    """The unroll is a dispatch grouping, not a numerics change: the loss
    trajectory and final params are BIT-identical to per-step calls."""
    cfg = get_config("qwen2-1.5b").reduced()
    model = build_model(cfg)
    opt = AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=30)
    dl = _loader(32, 2)
    batches = [next(iter_b) for iter_b in [iter(dl)] for _ in range(6)]
    dl.close()

    state_a = init_train_state(model, torch.Generator().manual_seed(0), opt)
    step = make_train_step(model, opt, remat="none")
    ref_losses = []
    for b in batches:
        state_a, m = step(state_a, b)
        ref_losses.append(m["loss"])

    state_b = init_train_state(model, torch.Generator().manual_seed(0), opt)
    unrolled = make_unrolled_train_step(model, opt, remat="none")
    got_losses = []
    for lo in (0, 3):
        window = {k: torch.stack([b[k] for b in batches[lo:lo + 3]])
                  for k in batches[0]}
        state_b, ms = unrolled(state_b, window)
        assert ms["loss"].shape == (3,)
        got_losses.extend(ms["loss"])

    assert torch.equal(torch.stack(ref_losses), torch.stack(got_losses))
    for k in state_a["params"]:
        assert torch.equal(state_a["params"][k], state_b["params"][k]), k


def test_donated_and_functional_steps_agree():
    """The step takes the state over and updates it in place; a step given
    a copy leaves the original as it was; both compute the same new
    state."""
    model = build_model(get_config("qwen2-1.5b").reduced())
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5)
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, 256, (2, 17)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    st = init_train_state(model, torch.Generator().manual_seed(5), opt)
    before = {k: v.clone() for k, v in st["params"].items()}
    copy = {"params": {k: v.clone() for k, v in st["params"].items()},
            "opt": {"m": {k: v.clone() for k, v in st["opt"]["m"].items()},
                    "v": {k: v.clone() for k, v in st["opt"]["v"].items()},
                    "step": st["opt"]["step"].clone()}}
    step = make_train_step(model, opt)
    kept, m_kept = step(copy, batch)
    assert all(torch.equal(st["params"][k], before[k]) for k in before)
    assert int(st["opt"]["step"]) == 0
    donated, m_don = step(st, batch)
    assert donated["params"]["embed"] is st["params"]["embed"]
    assert int(st["opt"]["step"]) == 1
    assert torch.equal(m_kept["loss"], m_don["loss"])
    for k in before:
        assert torch.equal(kept["params"][k], donated["params"][k]), k
        assert torch.equal(kept["opt"]["m"][k], donated["opt"]["m"][k]), k


def _rel(want: np.ndarray, got: np.ndarray) -> float:
    want = want.astype(np.float64)
    return float(np.linalg.norm(got.astype(np.float64) - want)
                 / np.linalg.norm(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_five_train_steps_match_reference(dtype):
    r_model = r_build(r_get_config("qwen2-1.5b").reduced())
    p_model = build_model(get_config("qwen2-1.5b").reduced())
    kw = dict(lr=2e-3, warmup_steps=2, total_steps=30)
    ro, po = ropt.AdamWConfig(**kw), AdamWConfig(**kw)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 256, (2, 33)).astype(np.int32)
               for _ in range(5)]
    rs = r_init_state(r_model, jax.random.key(0), ro, getattr(jnp, dtype))
    p0 = {k: np.asarray(v, np.float32) for k, v in rs["params"].items()}
    ps = state_from_numpy({k: np.asarray(v) for k, v in rs["params"].items()},
                          "cpu")
    r_step = jax.jit(r_make_step(r_model, ro, remat="none"))
    p_step = make_train_step(p_model, po, remat="none")
    rcm.set_unroll_scans(dtype == "float32")    # see test_torch_models.py
    try:
        for b in batches:
            rs, rmet = r_step(rs, {"tokens": jnp.asarray(b[:, :-1]),
                                   "labels": jnp.asarray(b[:, 1:])})
            ps, pmet = p_step(ps, {"tokens": torch.from_numpy(b[:, :-1]),
                                   "labels": torch.from_numpy(b[:, 1:])})
            want, got = float(rmet["loss"]), float(pmet["loss"])
            tol = 1e-4 if dtype == "float32" else 2e-2
            assert abs(got - want) <= tol * abs(want), (got, want)
            assert float(pmet["lr"]) == pytest.approx(float(rmet["lr"]),
                                                      rel=1e-6)
    finally:
        rcm.set_unroll_scans(False)
    assert int(ps["opt"]["step"]) == 5
    got = state_to_numpy(ps["params"], bfloat16=jnp.bfloat16)
    want = {k: np.asarray(v, np.float32) for k, v in rs["params"].items()}
    got = {k: np.asarray(got[k], np.float32) for k in want}
    prel = {k: _rel(want[k], got[k]) for k in want}
    urel = {k: _rel(want[k] - p0[k], got[k] - p0[k]) for k in want}
    upd_w = np.concatenate([(want[k] - p0[k]).ravel() for k in want])
    upd_g = np.concatenate([(got[k] - p0[k]).ravel() for k in want])
    whole = _rel(upd_w, upd_g)
    print(f"five steps {dtype}: params {max(prel.values()):.3e} "
          f"({max(prel, key=prel.get)}) update {max(urel.values()):.3e} "
          f"({max(urel, key=urel.get)}) whole update {whole:.3e}")
    for k in want:
        if dtype == "float32":
            assert urel[k] <= 1e-1 and prel[k] <= 1e-2, (k, urel[k], prel[k])
        else:
            assert prel[k] <= 2 ** -5, (k, prel[k])
    assert dtype == "float32" or whole <= 0.15, whole


def test_data_parallel_step_waits_for_the_multi_gpu_slice():
    """The data-parallel step is ported (`tests/test_torch_dp.py` holds it
    against the reference); a mesh wider than the process group's world
    is refused at construction."""
    from repro_torch.launch.mesh import make_mesh
    with pytest.raises(ValueError, match="2 data-parallel entries"):
        make_manual_dp_step(None, None,
                            make_mesh((2,), ("data",), ["cpu"] * 2))
