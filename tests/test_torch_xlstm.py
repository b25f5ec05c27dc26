"""The port's xLSTM against the JAX reference on the CPU: the pieces
(`mlstm_chunked`, `mlstm_step`, `slstm_scan`) and the family at
`reduced()` with the same weights in both
(`tests/_torch_families.py`).

Tolerances, measured on these inputs (worst seen in brackets):
  * `mlstm_chunked` against the reference: 1e-5 [2.2e-7]; a chain of
    `mlstm_step` against the chunked form: 1e-4 [2.2e-7: the chunked
    form sums decays in log space]; `slstm_scan`: 1e-5 [1.2e-7].
  * fp32: loss 1e-5 relative [7.6e-8]; logits 1e-4 relative norm
    [3.0e-6]; every gradient 1e-3 [8.0e-5, embed]; teacher-forced decode
    logits 1e-4 a step [9.9e-6], the states [3.4e-6].
  * bf16: loss 1e-3 [4.9e-5]; logits 4e-2 [5.9e-3]; every gradient 5e-2
    [1.4e-2]; decode logits and states 6e-2 [5.3e-3].
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import xlstm as r_xlstm
from repro_torch.models import xlstm as p_xlstm

import _torch_families as tf

ARCHS = ("xlstm-350m",)
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


# -------------------------------------------------------------- xLSTM
def _mlstm_inputs(seed=2, B=2, S=24, H=2, D=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)),
            rng.standard_normal((B, S, H, D)),
            rng.standard_normal((B, S, H, D)),
            rng.standard_normal((B, S, H)),
            rng.standard_normal((B, S, H)) + 2.0)


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked_matches_reference(with_state):
    q, k, v, i, f = _mlstm_inputs()
    B, S, H, D = q.shape
    rng = np.random.default_rng(3)
    state = ((rng.standard_normal((B, H, D, D)), rng.random((B, H, D)))
             if with_state else None)
    got, (C, n) = p_xlstm.mlstm_chunked(
        *(tf.t(a) for a in (q, k, v, i, f)), chunk=8,
        state=None if state is None else tuple(tf.t(s) for s in state))
    rs = None if state is None else tuple(tf.j(s) for s in state)
    want, (rC, rn) = r_xlstm.mlstm_chunked(
        *(tf.j(a) for a in (q, k, v, i, f)), chunk=8, state=rs)
    assert tf.rel(want, got) <= 1e-5
    assert tf.rel(rC, C) <= 1e-5 and tf.rel(rn, n) <= 1e-5


def test_mlstm_step_chain_matches_the_chunked_form():
    q, k, v, i, f = (tf.t(a) for a in _mlstm_inputs())
    B, S, H, D = q.shape
    whole, (C, n) = p_xlstm.mlstm_chunked(q, k, v, i, f, chunk=8)
    st = (torch.zeros(B, H, D, D), torch.zeros(B, H, D))
    hs = []
    for s in range(S):
        h, st = p_xlstm.mlstm_step(q[:, s], k[:, s], v[:, s], i[:, s],
                                   f[:, s], st)
        hs.append(h)
    assert tf.rel(whole, torch.stack(hs, 1)) <= 1e-4
    assert tf.rel(C, st[0]) <= 1e-4 and tf.rel(n, st[1]) <= 1e-4
    rh, _ = r_xlstm.mlstm_step(tf.j(q[:, 0]), tf.j(k[:, 0]), tf.j(v[:, 0]),
                               tf.j(i[:, 0]), tf.j(f[:, 0]),
                               (tf.j(np.zeros((B, H, D, D))),
                                tf.j(np.zeros((B, H, D)))))
    assert tf.rel(rh, hs[0]) <= 1e-6


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_matches_reference(with_state):
    rng = np.random.default_rng(4)
    B, S, H, D = 2, 11, 2, 8
    gates = rng.standard_normal((B, S, 4, H, D))
    r = rng.standard_normal((4, H, D, D)) / np.sqrt(D)
    state = None
    if with_state:
        state = (rng.standard_normal((B, H, D)), rng.random((B, H, D)) + 1,
                 rng.standard_normal((B, H, D)),
                 rng.standard_normal((B, H, D)))
    got, gst = p_xlstm.slstm_scan(
        tf.t(gates), tf.t(r),
        None if state is None else tuple(tf.t(s) for s in state))
    want, wst = r_xlstm.slstm_scan(
        tf.j(gates), tf.j(r),
        None if state is None else tuple(tf.j(s) for s in state))
    assert tf.rel(want, got) <= 1e-5
    for a, b in zip(wst, gst):
        assert tf.rel(a, b) <= 1e-5


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
