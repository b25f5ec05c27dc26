"""The port's RecurrentGemma against the JAX reference on the CPU: the
RG-LRU pieces (`rglru_scan`, `rglru_step`, `causal_conv4`) and the
family at `reduced()` with the same weights in both
(`tests/_torch_families.py`).

Tolerances, measured on these inputs (worst seen in brackets):
  * `rglru_scan` (doubling) against the reference's associative scan
    and against a chain of `rglru_step`: 1e-5 relative norm [fp32
    rounding of two reduction trees, 5.2e-8 / 5.1e-8].
  * `causal_conv4`: fp32 1e-6 [0.0]; bf16 one bf16 ulp (2^-7 relative)
    [0.0].
  * fp32: loss 1e-5 relative [7.6e-8]; logits 1e-4 relative norm
    [9.5e-7]; every gradient 1e-3 [2.1e-4, embed]; teacher-forced decode
    logits 1e-4 a step [1.6e-6], the caches [8.9e-7].
  * bf16: loss 1e-3 [2.8e-5]; logits 4e-2 [7.0e-3]; every gradient 5e-2
    [1.5e-2]; decode logits and caches 6e-2 [2.4e-3].
  * decode against the port's own forward (the reference test's bound):
    atol = rtol = 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import rglru as r_rglru
from repro_torch.models import rglru as p_rglru

import _torch_families as tf

ARCHS = ("recurrentgemma-2b",)
TOL = {"float32": dict(loss=1e-5, logits=1e-4, grad=1e-3, decode=1e-4),
       "bfloat16": dict(loss=1e-3, logits=4e-2, grad=5e-2, decode=6e-2)}

@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ------------------------------------------------------------- RG-LRU
def _lru_inputs(seed=0, B=2, S=37, R=16):
    rng = np.random.default_rng(seed)
    sig = lambda a: 1 / (1 + np.exp(-a))                         # noqa: E731
    return (rng.standard_normal((B, S, R)),
            sig(rng.standard_normal((B, S, R))),
            sig(rng.standard_normal((B, S, R))),
            rng.standard_normal(R))

def test_rglru_scan_matches_reference_and_step_chain():
    x, r, i, lam = _lru_inputs()
    got = p_rglru.rglru_scan(*(tf.t(a) for a in (x, r, i, lam)))
    want = r_rglru.rglru_scan(*(tf.j(a) for a in (x, r, i, lam)))
    assert tf.rel(want, got) <= 1e-5
    h = torch.zeros(x.shape[0], x.shape[2])
    chain = []
    for s in range(x.shape[1]):
        h = p_rglru.rglru_step(tf.t(x[:, s]), tf.t(r[:, s]), tf.t(i[:, s]),
                               tf.t(lam), h)
        chain.append(h)
    assert tf.rel(torch.stack(chain, 1), got) <= 1e-5
    step = r_rglru.rglru_step(tf.j(x[:, 0]), tf.j(r[:, 0]), tf.j(i[:, 0]),
                              tf.j(lam), tf.j(np.ones(x[:, 0].shape)))
    got1 = p_rglru.rglru_step(tf.t(x[:, 0]), tf.t(r[:, 0]), tf.t(i[:, 0]),
                              tf.t(lam), torch.ones(x[:, 0].shape))
    assert tf.rel(step, got1) <= 1e-6

@pytest.mark.parametrize("dtype", tf.DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv4_matches(dtype, with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 16))
    kern = rng.standard_normal((4, 16))
    state = rng.standard_normal((2, 3, 16)) if with_state else None
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    out, st = p_rglru.causal_conv4(
        tf.t(x, td), tf.t(kern, td),
        None if state is None else tf.t(state))          # fp32, as cached
    want, wst = r_rglru.causal_conv4(
        tf.j(x, jd), tf.j(kern, jd),
        None if state is None else tf.j(state))
    assert out.dtype == st.dtype == td
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(tf.np32(out.float()), tf.np32(want),
                               rtol=tol, atol=tol)
    np.testing.assert_array_equal(tf.np32(st.float()), tf.np32(wst))
    # the state is the last three inputs: a step continues the sequence
    whole, _ = p_rglru.causal_conv4(tf.t(x), tf.t(kern))
    head, hst = p_rglru.causal_conv4(tf.t(x[:, :5]), tf.t(kern))
    tail, _ = p_rglru.causal_conv4(tf.t(x[:, 5:]), tf.t(kern), hst)
    torch.testing.assert_close(torch.cat([head, tail], 1), whole)

# ------------------------------------------------------------ families
@pytest.mark.parametrize("dtype", tf.DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_family_loss_logits_and_grads_match(arch, dtype):
    rm, _ = tf.models(arch)
    b = tf.batch(rm.cfg)
    want_loss, want_grads, want_logits = tf.ref_run(arch, dtype, b)
    loss, grads, logits = tf.port_run(arch, dtype, b)
    tol = TOL[dtype]
    assert logits.dtype == getattr(torch, dtype)
    assert abs(loss - want_loss) <= tol["loss"] * abs(want_loss)
    assert tf.rel(want_logits, logits.float()) <= tol["logits"]
    assert set(grads) == set(want_grads)
    for k, g in grads.items():
        assert g.dtype == getattr(torch, dtype), k
        assert tf.rel(want_grads[k], g.float()) <= tol["grad"], k

@pytest.mark.parametrize("dtype", tf.DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_family_decode_steps_match_reference(arch, dtype):
    """Teacher-forced decode from a zero cache: every step's logits, and
    the caches after the last."""
    rm, _ = tf.models(arch)
    toks = tf.batch(rm.cfg, S=10, seed=5)["tokens"]
    want, rcache = tf.ref_decode(arch, dtype, toks, 16)
    got, cache = tf.port_decode(arch, dtype, toks, 16)
    tol = TOL[dtype]["decode"]
    for s in range(toks.shape[1]):
        assert tf.rel(want[:, s], got[:, s].float()) <= tol, s
    assert set(cache) == set(rcache)
    for k in cache:
        assert tuple(cache[k].shape) == rcache[k].shape, k
        if k == "pos":
            np.testing.assert_array_equal(cache[k].numpy(),
                                          np.asarray(rcache[k]))
        else:
            assert tf.rel(np.asarray(rcache[k], np.float32),
                          cache[k].float()) <= tol, k

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_session_greedy_tokens_equal_reference(arch, monkeypatch):
    ctx = np.random.default_rng(6).integers(0, 256, (2, 6)).astype(np.int32)
    want, got = tf.greedy_tokens(arch, monkeypatch, ctx)
    assert got.shape == (2, 5) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)

@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_axes_and_init_match_reference(arch):
    rm, pm = tf.models(arch)
    for S in (8, 100):
        specs, rspecs = pm.cache_specs(3, S), rm.cache_specs(3, S)
        assert list(specs) == list(rspecs)
        for k in specs:
            assert specs[k].device.type == "meta"
            assert tuple(specs[k].shape) == rspecs[k].shape, k
            assert str(specs[k].dtype).split(".")[1] == str(rspecs[k].dtype)
        got, want = pm.init_cache(3, S, device="cpu"), rm.init_cache(3, S)
        for k in want:
            np.testing.assert_array_equal(tf.np32(got[k].float()),
                                          np.asarray(want[k], np.float32))
    assert pm.cache_axes() == rm.cache_axes()

@pytest.mark.parametrize("dtype", tf.DTYPES)
def test_recurrentgemma_decode_matches_forward(dtype):
    """`tests/test_models_smoke.py::test_decode_matches_forward` on the
    port, and past the local window: a ring of 4 slots over 6 steps
    equals the forward with a window of 4."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config("recurrentgemma-2b").reduced()
    for window, S in ((cfg.local_window, 16), (4, 16)):
        model = build_model(dataclasses.replace(cfg, local_window=window))
        params = model.init(torch.Generator().manual_seed(0),
                            getattr(torch, dtype))
        toks = torch.from_numpy((np.arange(12).reshape(2, 6) * 13
                                 % cfg.vocab).astype(np.int32))
        cache = model.init_cache(2, S, dtype=getattr(torch, dtype),
                                 device="cpu")
        assert cache["k"].shape[2] == min(window, S)
        outs = []
        with torch.no_grad():
            for s in range(toks.shape[1]):
                lg, cache = model.decode_step(params, cache, toks[:, s:s + 1])
                outs.append(lg)
            fwd = model.forward(params, toks, remat="none")
        np.testing.assert_allclose(tf.np32(torch.stack(outs, 1).float()),
                                   tf.np32(fwd.float()), atol=1e-5,
                                   rtol=1e-5)

def test_recurrentgemma_init_sets_the_decay_parameter():
    _, pm = tf.models("recurrentgemma-2b")
    p = pm.init(torch.Generator().manual_seed(0))
    for k in ("rec/lam", "tail/lam"):
        assert torch.equal(p[k], torch.full_like(p[k], 0.65))
    assert pm.n_groups == 1 and pm.n_tail == 2 and pm.rec_per_group == 2
