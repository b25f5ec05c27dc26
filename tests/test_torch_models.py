"""The port's model substrate and `DenseLM` against the JAX reference.

The same numpy inputs go through `repro.models.common` / `DenseLM` and
their `repro_torch` counterparts on the CPU. Weights are the
reference's, carried across with `repro_torch.training.convert`.

Tolerances, measured on these inputs (worst seen in brackets):
  * fp32 `DenseLM` loss: 1e-4 relative [1.5e-7]; logits 1e-5 relative
    norm [5.5e-7]; every gradient 1e-3 relative norm [5.6e-5].
  * bf16 `DenseLM` loss: 2e-2 relative [2.0e-5]; every gradient 5e-2
    relative norm [1.7e-2: bf16 products round each partial result].
  * per-function parity: stated at each test.
The reference's fp32 forward runs with `set_unroll_scans(True)`: its
layer scan needs a carry of one dtype, and the bf16 embedding turns into
fp32 after the first residual when the weights are fp32, so the scanned
form raises a TypeError (the unrolled form is the reference's own
dry-run lowering and computes the same layers).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as r_get_config
from repro.models import common as rcm
from repro.models.registry import build_model as r_build
from repro_torch.configs import get_config as p_get_config, ALL_ARCHS
from repro_torch.models import common as pcm
from repro_torch.models.registry import build_model as p_build
from repro_torch.training.convert import state_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _t(x: np.ndarray, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _j(x: np.ndarray, dtype=jnp.bfloat16):
    return jnp.asarray(np.asarray(x, np.float32)).astype(dtype)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


# ------------------------------------------------------------ configs
def test_configs_equal_the_reference():
    for name in ALL_ARCHS:
        r, p = r_get_config(name), p_get_config(name)
        assert vars(r) == vars(p), name
        assert vars(r.reduced()) == vars(p.reduced()), name


def test_registry_builds_dense_and_names_the_slice_of_the_rest():
    """Every config builds, as the reference's class, with the
    reference's parameter shapes."""
    assert p_build("qwen2-1.5b").cfg.n_layers == 28
    for name in ALL_ARCHS:
        pm, rm = p_build(name), r_build(r_get_config(name))
        assert type(pm).__name__ == type(rm).__name__, name
        assert pm.param_defs() == rm.param_defs(), name
    with pytest.raises(ValueError, match="unknown family"):
        import dataclasses
        p_build(dataclasses.replace(p_get_config("qwen2-1.5b"),
                                    family="rnn"))


# ------------------------------------------------------ per function
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 64)) * 3
    w = rng.standard_normal(64)
    b = rng.standard_normal(64)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    # fp32: 1e-6 relative; bf16: both round the same fp32 value, so at
    # most one bf16 ulp apart (2^-7 relative)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    got = pcm.rms_norm(_t(x, td), _t(w, td), 1e-6)
    want = rcm.rms_norm(_j(x, jd), _j(w, jd), 1e-6)
    assert got.dtype == td
    np.testing.assert_allclose(_np(got.float()), _np(want), rtol=tol,
                               atol=tol)
    got = pcm.layer_norm(_t(x, td), _t(w, td), _t(b, td), 1e-5)
    want = rcm.layer_norm(_j(x, jd), _j(w, jd), _j(b, jd), 1e-5)
    np.testing.assert_allclose(_np(got.float()), _np(want), rtol=tol,
                               atol=4 * tol)


def test_rope_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 4, 32))
    pos = np.arange(40, dtype=np.int32)[None, :]
    got = pcm.apply_rope(_t(x, torch.float32), torch.from_numpy(pos), 1e6)
    want = rcm.apply_rope(_j(x, jnp.float32), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    got = pcm.apply_rope(_t(x), torch.from_numpy(pos), 1e6)
    assert got.dtype == torch.bfloat16
    want = rcm.apply_rope(_j(x), jnp.asarray(pos), 1e6)
    # bf16 out of an fp32 rotation: one bf16 ulp
    np.testing.assert_allclose(_np(got.float()), _np(want), rtol=2 ** -7,
                               atol=2 ** -7)


def _qkv(seed, B=2, Sq=16, Sk=64, KV=2, G=3, D=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, KV * G, D)),
            rng.standard_normal((B, Sk, KV, D)),
            rng.standard_normal((B, Sk, KV, D)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_attention_full_and_blockwise_match(causal, window, chunk):
    q, k, v = _qkv(0)
    pq, pk, pv = _t(q), _t(k), _t(v)
    jq, jk, jv = _j(q), _j(k), _j(v)
    full = pcm.gqa_attention(pq, pk, pv, causal=causal, window=window)
    bw = pcm.gqa_attention_blockwise(pq, pk, pv, causal=causal,
                                     window=window, kv_chunk=chunk)
    r_full = rcm.gqa_attention(jq, jk, jv, causal=causal, window=window)
    r_bw = rcm.gqa_attention_blockwise(jq, jk, jv, causal=causal,
                                       window=window, kv_chunk=chunk)
    assert full.dtype == bw.dtype == torch.bfloat16
    # port against reference, same algorithm: fp32 products rounded to
    # bf16 once at the end, so two bf16 ulps of the largest output
    np.testing.assert_allclose(_np(full.float()), _np(r_full), atol=2e-2)
    np.testing.assert_allclose(_np(bw.float()), _np(r_bw), atol=2e-2)
    # blockwise against full, as the reference's own test holds it
    np.testing.assert_allclose(_np(full.float()), _np(bw.float()),
                               atol=0.05)


def test_attention_fp32_matches_tightly():
    q, k, v = _qkv(2)
    got = pcm.gqa_attention(*(_t(a, torch.float32) for a in (q, k, v)))
    want = rcm.gqa_attention(*(_j(a, jnp.float32) for a in (q, k, v)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_blockwise_switch_respected():
    q, k, v = (_t(a) for a in _qkv(1, B=1, Sq=8, Sk=32, G=2))
    ref = pcm.gqa_attention(q, k, v, causal=True)
    pcm.set_attn_impl("blockwise", 8)
    try:
        out = pcm.gqa_attention(q, k, v, causal=True)
    finally:
        pcm.set_attn_impl("full")
    np.testing.assert_allclose(_np(ref.float()), _np(out.float()),
                               atol=0.05)


def test_swiglu_matches_with_dtype_promotion():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32))
    wg, wu = (rng.standard_normal((32, 48)) / 6 for _ in range(2))
    wd = rng.standard_normal((48, 32)) / 7
    for xd, wdt in (("float32", "float32"), ("bfloat16", "bfloat16"),
                    ("bfloat16", "float32")):
        got = pcm.swiglu(_t(x, getattr(torch, xd)),
                         *(_t(w, getattr(torch, wdt)) for w in (wg, wu, wd)))
        want = rcm.swiglu(_j(x, getattr(jnp, xd)),
                          *(_j(w, getattr(jnp, wdt)) for w in (wg, wu, wd)))
        assert str(got.dtype).split(".")[1] == str(want.dtype)
        # fp32 out: 1e-5; bf16 out: the bf16 products round differently
        # summed, 3e-2 relative norm
        tol = 1e-5 if got.dtype == torch.float32 else 3e-2
        assert _rel(want, got.float()) <= tol, (xd, wdt)


def test_cross_entropy_matches():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 9, 300)) * 4
    labels = rng.integers(0, 300, (2, 9)).astype(np.int32)
    for dt in ("float32", "bfloat16"):
        got = pcm.cross_entropy_loss(_t(logits, getattr(torch, dt)),
                                     torch.from_numpy(labels), 300)
        want = rcm.cross_entropy_loss(_j(logits, getattr(jnp, dt)),
                                      jnp.asarray(labels), 300)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


# ------------------------------------------------------------ DenseLM
@pytest.fixture(scope="module")
def models():
    return (r_build(r_get_config("qwen2-1.5b").reduced()),
            p_build(p_get_config("qwen2-1.5b").reduced()))


@pytest.fixture(scope="module")
def batch():
    toks = np.random.default_rng(5).integers(0, 256, (2, 33)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _ref_value_and_grad(rm, params, tokens, labels, unroll):
    rcm.set_unroll_scans(unroll)
    try:
        b = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
        loss, grads = jax.value_and_grad(
            lambda p: rm.loss(p, b, remat="none"))(params)
        logits = rm.forward(params, b["tokens"], remat="none")
        return float(loss), grads, _np(logits)
    finally:
        rcm.set_unroll_scans(False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_lm_loss_logits_and_grads_match(models, batch, dtype):
    rm, pm = models
    tokens, labels = batch
    rp = rm.init(jax.random.key(0), getattr(jnp, dtype))
    want_loss, want_grads, want_logits = _ref_value_and_grad(
        rm, rp, tokens, labels, unroll=dtype == "float32")
    params = state_from_numpy({k: np.asarray(v) for k, v in rp.items()},
                              "cpu")["params"]
    assert all(params[k].dtype == getattr(torch, dtype) for k in params)
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    pb = {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}
    loss = pm.loss(leaves, pb, remat="none")
    loss.backward()
    with torch.no_grad():
        logits = pm.forward(params, pb["tokens"], remat="none")
    assert logits.dtype == torch.bfloat16 if dtype == "bfloat16" \
        else logits.dtype == torch.float32
    rel_loss = abs(loss.item() - want_loss) / abs(want_loss)
    if dtype == "float32":
        assert rel_loss <= 1e-4, rel_loss
        assert _rel(want_logits, logits) <= 1e-5
        grad_tol = 1e-3
    else:
        assert rel_loss <= 2e-2, rel_loss
        grad_tol = 5e-2
    assert set(want_grads) == set(leaves)
    for k in leaves:
        assert leaves[k].grad.dtype == getattr(torch, dtype)
        r = _rel(want_grads[k], leaves[k].grad.float())
        assert r <= grad_tol, (k, r)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_is_bit_equal_to_none(models, batch, remat):
    _, pm = models
    tokens, labels = batch
    pb = {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}
    params = pm.init(torch.Generator().manual_seed(3))
    out = {}
    for r in ("none", remat):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        loss = pm.loss(leaves, pb, remat=r)
        loss.backward()
        out[r] = (loss.detach(), {k: v.grad for k, v in leaves.items()})
    assert torch.equal(out["none"][0], out[remat][0])
    for k in params:
        assert torch.equal(out["none"][1][k], out[remat][1][k]), k


def test_init_is_stable_and_follows_the_reference_distributions(models):
    _, pm = models
    a = pm.init(torch.Generator().manual_seed(7))
    b = pm.init(torch.Generator().manual_seed(7))
    c = pm.init(torch.Generator().manual_seed(8))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers/wq"], c["layers/wq"])
    assert torch.equal(a["final_norm"], torch.ones_like(a["final_norm"]))
    assert torch.equal(a["layers/attn_norm"],
                       torch.ones_like(a["layers/attn_norm"]))
    assert a["embed"].dtype == torch.bfloat16
    assert abs(a["embed"].float().std().item() - 0.02) < 0.002
    E = pm.cfg.d_model
    assert abs(a["layers/wq"].float().std().item() - E ** -0.5) < 0.01
    assert set(a) == set(pm.param_defs())


def test_serving_parts_name_their_slice(models):
    """The KV cache and decode step are ported (held against the
    reference in test_torch_serve_model.py), and so are the VLM's inputs:
    `mrope` ids with t = h = w give the RoPE forward bit for bit."""
    _, pm = models
    params = pm.init(torch.Generator().manual_seed(1))
    logits, cache = pm.decode_step(params, pm.init_cache(1, 4, device="cpu"),
                                   torch.zeros((1, 1), dtype=torch.int32))
    assert logits.shape == (1, pm.cfg.vocab) and int(cache["pos"][0]) == 1
    toks = torch.arange(6, dtype=torch.int32)[None]
    ids = torch.arange(6, dtype=torch.int32)[None, None].expand(3, 1, 6)
    with torch.no_grad():
        assert torch.equal(pm.forward(params, toks, mrope=ids, remat="none"),
                           pm.forward(params, toks, remat="none"))
