"""The port's Whisper against the JAX reference on the CPU: the
sinusoid positions, the encoder, the loss, logits and gradients, the
teacher-forced decode from a cross cache primed by `init_cache(params=,
frames=)`, the unprimed (zero) cross cache that `ServeSession` gets,
and the greedy tokens of `ServeSession`, at `reduced()` with the same
weights in both (`tests/_torch_families.py`).

Tolerances, measured on these inputs (worst seen in brackets):
  * `sinusoid_pos`: 1e-4 absolute [3.1e-5 at positions up to 1562:
    fp32 sin/cos of large angles; 9.5e-7 from 0].
  * fp32: encoder output 5e-5 relative norm [2.4e-5]; loss 1e-5
    relative [0.0]; logits 1e-5 [7.9e-7]; every gradient 1e-3 [6.6e-5];
    primed cross K/V and decode logits 1e-5 a step [4.1e-7].
  * bf16: encoder output 2e-2 [2.5e-3]; loss 2e-2 [3.1e-6]; logits 3e-2
    [5.9e-3]; every gradient 5e-2 [1.1e-2]; cross K/V and decode logits
    2e-2 a step [8.2e-3].
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import common as rcm
from repro.models import whisper as r_whisper
from repro_torch.models import whisper as p_whisper

import _torch_families as tf

ARCH = "whisper-medium"
TOL = {"float32": dict(enc=5e-5, loss=1e-5, logits=1e-5, grad=1e-3,
                       decode=1e-5),
       "bfloat16": dict(enc=2e-2, loss=2e-2, logits=3e-2, grad=5e-2,
                        decode=2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("offset", [0, 1499])
def test_sinusoid_pos_matches(offset):
    want = r_whisper.sinusoid_pos(64, 128, offset=offset)
    got = p_whisper.sinusoid_pos(64, 128, offset=offset)
    # both round the angle to fp32 alike; their sin/cos of angles near
    # 1500 differ by up to 3.1e-5, as each differs from float64 by 8.4e-5
    np.testing.assert_allclose(got.numpy(), tf.np32(want), atol=1e-4)
    # a device position (decode) gives the same row as an int offset
    pos = torch.tensor([offset], dtype=torch.int32)
    row = p_whisper.sinusoid_pos(1, 128, offset=pos)
    assert torch.equal(row[0], got[0])


@pytest.mark.parametrize("dtype", tf.DTYPES)
def test_encoder_matches(dtype):
    rm, pm = tf.models(ARCH)
    rp, pp = tf.weights(ARCH, dtype)
    frames = tf.batch(rm.cfg)["frames"]
    rcm.set_unroll_scans(dtype == "float32")
    try:
        want = tf.jit(lambda p, f: rm.encode(p, f, remat="none"))(
            rp, jnp.asarray(frames))
    finally:
        rcm.set_unroll_scans(False)
    with torch.no_grad():
        got = pm.encode(pp, torch.from_numpy(frames), remat="none")
    assert got.dtype == getattr(torch, dtype)
    assert tf.rel(want, got.float()) <= TOL[dtype]["enc"]


@pytest.mark.parametrize("dtype", tf.DTYPES)
def test_loss_logits_and_grads_match(dtype):
    rm, _ = tf.models(ARCH)
    b = tf.batch(rm.cfg)
    want_loss, want_grads, want_logits = tf.ref_run(ARCH, dtype, b)
    loss, grads, logits = tf.port_run(ARCH, dtype, b)
    tol = TOL[dtype]
    assert logits.dtype == getattr(torch, dtype)
    assert abs(loss - want_loss) <= tol["loss"] * abs(want_loss)
    assert tf.rel(want_logits, logits.float()) <= tol["logits"]
    assert set(grads) == set(want_grads)
    for k, g in grads.items():
        assert tf.rel(want_grads[k], g.float()) <= tol["grad"], k


@pytest.mark.parametrize("dtype", tf.DTYPES)
def test_primed_decode_matches_reference(dtype):
    """`init_cache(params=, frames=)` primes the cross K/V from the
    encoder; teacher-forced decode steps against it."""
    rm, _ = tf.models(ARCH)
    b = tf.batch(rm.cfg, S=8, seed=3)
    want, rcache = tf.ref_decode(ARCH, dtype, b["tokens"], 12,
                                 frames=b["frames"])
    got, cache = tf.port_decode(ARCH, dtype, b["tokens"], 12,
                                frames=b["frames"])
    tol = TOL[dtype]["decode"]
    for k in ("xk", "xv", "k", "v"):
        assert cache[k].dtype == getattr(torch, dtype)
        assert tuple(cache[k].shape) == rcache[k].shape, k
        assert tf.rel(np.asarray(rcache[k], np.float32),
                      cache[k].float()) <= tol, k
    assert cache["xk"].abs().sum() > 0
    for s in range(b["tokens"].shape[1]):
        assert tf.rel(want[:, s], got[:, s].float()) <= tol, s


def test_unprimed_cross_cache_is_zero_as_served():
    """Without params and frames the cross K/V stay zero in both
    packages (what `ServeSession.prime` gets), and decode runs on it."""
    rm, pm = tf.models(ARCH)
    cache, rcache = pm.init_cache(2, 8, device="cpu"), rm.init_cache(2, 8)
    for k in rcache:
        assert tuple(cache[k].shape) == rcache[k].shape
        assert cache[k].dtype == (torch.int32 if k == "pos"
                                  else torch.bfloat16)
        assert not cache[k].any() and not np.asarray(rcache[k]).any()
    toks = tf.batch(rm.cfg, S=6, seed=4)["tokens"]
    want, _ = tf.ref_decode(ARCH, "float32", toks, 8)
    got, _ = tf.port_decode(ARCH, "float32", toks, 8)
    for s in range(toks.shape[1]):
        assert tf.rel(want[:, s], got[:, s]) <= TOL["float32"]["decode"], s
    assert pm.cache_axes() == rm.cache_axes()


def test_serve_session_greedy_tokens_equal_reference(monkeypatch):
    ctx = np.random.default_rng(6).integers(0, 256, (2, 6)).astype(np.int32)
    want, got = tf.greedy_tokens(ARCH, monkeypatch, ctx)
    assert got.shape == (2, 5) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_loss_without_frames_raises_as_the_reference_does():
    """The batch of `ArchiveDataset` has no frames: both packages raise."""
    rm, pm = tf.models(ARCH)
    rp, pp = tf.weights(ARCH, "bfloat16")
    toks = tf.batch(rm.cfg, S=8)["tokens"]
    with pytest.raises(KeyError, match="frames"):
        rm.loss(rp, {"tokens": jnp.asarray(toks),
                     "labels": jnp.asarray(toks)})
    with pytest.raises(KeyError, match="frames"):
        pm.loss(pp, {"tokens": torch.from_numpy(toks),
                     "labels": torch.from_numpy(toks)})
