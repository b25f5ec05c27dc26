"""The port's M-RoPE, MoE and VLM against the JAX reference on the CPU:
`apply_mrope` and `cross_attention`, `moe_ffn` with its router and
capacity selection (ties and overflow included), and the MoE (qwen3-moe,
grok-1) and VLM (qwen2-vl) families at `reduced()` with the same
weights in both (`tests/_torch_families.py`).

Tolerances, measured on these inputs (worst seen in brackets):
  * `apply_mrope`: fp32 1e-5 [2.4e-7]; bf16 one bf16 ulp (2^-7) [0.0];
    with t = h = w it is `apply_rope` bit for bit.
  * `moe_ffn`: fp32 1e-5 relative norm [1.3e-7, ties and overflow
    included]; bf16 2e-2 [0.0]. The router's and the capacity step's
    indices are equal, ties included.
  * families (qwen3-moe, qwen2-vl; grok-1 in fp32), fp32: loss 1e-5
    relative [7.6e-8]; logits 1e-5 relative norm [7.1e-7]; every
    gradient 1e-3 [1.7e-4, embed]; teacher-forced decode logits 1e-5 a
    step [7.0e-7].
  * families, bf16: loss 2e-2 [1.0e-5]; logits 3e-2 [3.6e-3]; every
    gradient 5e-2 [2.0e-2]; decode logits 2e-2 a step [3.3e-5].
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import common as rcm
from repro.models import moe as r_moe
from repro.models.transformer import DenseLM as RDenseLM
from repro_torch.configs import ALL_ARCHS, SHAPES_BY_NAME
from repro_torch.models import common as pcm
from repro_torch.models import moe as p_moe
from repro_torch.models.transformer import DenseLM

import _torch_families as tf

ARCHS = ("qwen3-moe-235b-a22b", "qwen2-vl-2b")
TOL = {"float32": dict(loss=1e-5, logits=1e-5, grad=1e-3, decode=1e-5),
       "bfloat16": dict(loss=2e-2, logits=3e-2, grad=5e-2, decode=2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -------------------------------------------------------------- M-RoPE
def _mrope_ids(rng, B, S):
    return rng.integers(0, 50, (3, B, S)).astype(np.int32)


@pytest.mark.parametrize("dtype", tf.DTYPES)
def test_apply_mrope_matches(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 4, 32))
    ids = _mrope_ids(rng, 2, 12)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    got = pcm.apply_mrope(tf.t(x, td), torch.from_numpy(ids), 1e6, (4, 6, 6))
    want = rcm.apply_mrope(tf.j(x, jd), jnp.asarray(ids), 1e6, (4, 6, 6))
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(tf.np32(got.float()), tf.np32(want),
                               rtol=tol, atol=tol)


def test_apply_mrope_is_apply_rope_when_t_h_w_agree():
    rng = np.random.default_rng(1)
    x = tf.t(rng.standard_normal((2, 9, 3, 64)))
    pos = torch.from_numpy(rng.integers(0, 4000, (2, 9)).astype(np.int32))
    got = pcm.apply_mrope(x, pos[None].expand(3, 2, 9), 1e6, (16, 8, 8))
    assert torch.equal(got, pcm.apply_rope(x, pos, 1e6))
    with pytest.raises(AssertionError, match="head_dim/2"):
        pcm.apply_mrope(x, pos[None].expand(3, 2, 9), 1e6, (16, 8, 7))


def test_cross_attention_matches():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 5, 4, 16))
    k, v = (rng.standard_normal((2, 13, 4, 16)) for _ in range(2))
    got = pcm.cross_attention(tf.t(q), tf.t(k), tf.t(v))
    want = rcm.cross_attention(tf.j(q), tf.j(k), tf.j(v))
    np.testing.assert_allclose(tf.np32(got), tf.np32(want), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------- MoE
MOE_SHAPE = dict(B=2, S=24, E=32, F=48, Ex=8, k=2, cf=1.25)


def _moe_inputs(case: str, seed=3):
    c = MOE_SHAPE
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c["B"], c["S"], c["E"]))
    w_router = rng.standard_normal((c["E"], c["Ex"])) / 4
    if case == "ties":
        # a zero router: every probability 1/Ex, so every token takes
        # experts 0..k-1 with gate 1/k, and the capacity step ties
        # across the whole sequence
        w_router[:] = 0.0
    elif case == "overflow":
        # every token prefers expert 0: S tokens for C slots
        x[..., 0] = 5.0
        w_router[0, 0] = 3.0
    ws = (rng.standard_normal((c["Ex"], c["E"], c["F"])) / 6,
          rng.standard_normal((c["Ex"], c["E"], c["F"])) / 6,
          rng.standard_normal((c["Ex"], c["F"], c["E"])) / 7)
    return x, w_router, ws


def _ref_selection(x, w_router):
    """The reference's router and capacity step (moe.py:38-46, :63-64)
    in jax: top-k indices per token, then each expert's top-C tokens."""
    c = MOE_SHAPE
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32)
                           @ jnp.asarray(w_router, jnp.float32), axis=-1)
    top_v, top_i = jax.lax.top_k(probs, c["k"])
    top_v = top_v / jnp.maximum(top_v.sum(-1, keepdims=True), 1e-9)
    B, S = x.shape[:2]
    bi = jnp.broadcast_to(jnp.arange(B)[:, None, None], top_i.shape)
    si = jnp.broadcast_to(jnp.arange(S)[None, :, None], top_i.shape)
    gate = jnp.zeros((B, S, c["Ex"]), jnp.float32).at[bi, si, top_i].add(
        top_v)
    C = min(S, max(1, int(S * c["k"] / c["Ex"] * c["cf"])))
    score = jnp.where(jnp.moveaxis(gate, -1, 0) > 0,
                      jnp.moveaxis(gate, -1, 0), -1.0)
    cap_v, cap_i = jax.lax.top_k(score, C)
    return np.asarray(top_i), np.asarray(gate), np.asarray(cap_v), \
        np.asarray(cap_i)


@pytest.mark.parametrize("case", ["random", "overflow", "ties"])
def test_moe_router_and_capacity_indices_equal_reference(case):
    x, w_router, ws = _moe_inputs(case)
    c = MOE_SHAPE
    top_i, gate, cap_v, cap_i = _ref_selection(x, w_router)
    probs = torch.softmax(tf.t(x) @ tf.t(w_router), -1)
    _, p_top_i = p_moe.xla_top_k(probs, c["k"])
    np.testing.assert_array_equal(p_top_i.numpy(), top_i)
    p_gate = p_moe.route(tf.t(x), tf.t(w_router), c["k"])
    np.testing.assert_allclose(p_gate.numpy(), gate, rtol=1e-6, atol=1e-7)
    C = p_moe.capacity(x.shape[1], c["k"], c["Ex"], c["cf"])
    assert C == cap_i.shape[-1]
    p_cap_v, p_cap_i = p_moe.capacity_select(p_gate.movedim(-1, 0), C)
    np.testing.assert_array_equal(p_cap_i.numpy(), cap_i)
    np.testing.assert_allclose(p_cap_v.numpy(), cap_v, rtol=1e-6, atol=1e-7)
    if case == "overflow":
        assert (gate[..., 0] > 0).sum(-1).min() > C      # tokens dropped
    if case == "ties":
        assert (cap_v[:2] == 1.0 / c["k"]).all()         # every slot ties
        np.testing.assert_array_equal(
            cap_i[2:], np.broadcast_to(np.arange(C), cap_i[2:].shape))
    # and the whole layer
    got = p_moe.moe_ffn(tf.t(x), tf.t(w_router), *(tf.t(w) for w in ws),
                        c["k"], c["cf"])
    want = r_moe.moe_ffn(tf.j(x), tf.j(w_router), *(tf.j(w) for w in ws),
                         c["k"], c["cf"])
    assert tf.rel(want, got) <= 1e-5


@pytest.mark.parametrize("dtype", tf.DTYPES)
def test_moe_ffn_matches(dtype):
    x, w_router, ws = _moe_inputs("random", seed=4)
    c = MOE_SHAPE
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    got = p_moe.moe_ffn(tf.t(x, td), tf.t(w_router, td),
                        *(tf.t(w, td) for w in ws), c["k"], c["cf"])
    want = r_moe.moe_ffn(tf.j(x, jd), tf.j(w_router, jd),
                         *(tf.j(w, jd) for w in ws), c["k"], c["cf"])
    assert got.dtype == td
    assert tf.rel(want, got.float()) <= (1e-5 if dtype == "float32"
                                         else 2e-2)


def test_moe_dispatch_chunks_and_capacity():
    """The expert chunk and the capacity of the published configs."""
    assert [p_moe.expert_chunk(n) for n in (128, 8, 4, 6, 3)] == \
        [16, 8, 4, 2, 1]
    assert p_moe.capacity(255, 8, 128, 1.25) == 19
    assert p_moe.capacity(255, 2, 8, 1.25) == 79
    assert p_moe.capacity(1, 8, 128, 1.25) == 1
    assert p_moe.capacity(4, 2, 4, 10.0) == 4


def test_moe_active_params_match_reference():
    from repro.configs import get_config as r_get_config
    from repro.models.registry import build_model as r_build
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    for arch in ("qwen3-moe-235b-a22b", "grok-1-314b"):
        assert build_model(get_config(arch)).active_params_per_token() == \
            r_build(r_get_config(arch)).active_params_per_token()
    rm, pm = tf.models("qwen3-moe-235b-a22b")
    assert pm.param_defs() == rm.param_defs()


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


def test_grok_loss_and_grads_match_fp32():
    arch = "grok-1-314b"
    rm, _ = tf.models(arch)
    b = tf.batch(rm.cfg, seed=1)
    want_loss, want_grads, _ = tf.ref_run(arch, "float32", b)
    loss, grads, _ = tf.port_run(arch, "float32", b)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for k, g in grads.items():
        assert tf.rel(want_grads[k], g) <= 1e-3, k


@pytest.mark.parametrize("dtype", tf.DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_family_decode_steps_match_reference(arch, dtype):
    """Teacher-forced decode from a zero cache (the VLM with its default
    text-only M-RoPE ids from the cache's position)."""
    rm, _ = tf.models(arch)
    toks = tf.batch(rm.cfg, S=8, seed=5)["tokens"]
    want, rcache = tf.ref_decode(arch, dtype, toks, 12)
    got, cache = tf.port_decode(arch, dtype, toks, 12)
    tol = TOL[dtype]["decode"]
    for s in range(toks.shape[1]):
        assert tf.rel(want[:, s], got[:, s].float()) <= tol, s
    for k in ("k", "v"):
        assert tf.rel(np.asarray(rcache[k], np.float32),
                      cache[k].float()) <= tol, k
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(rcache["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_session_greedy_tokens_equal_reference(arch, monkeypatch):
    ctx = np.random.default_rng(6).integers(0, 256, (2, 6)).astype(np.int32)
    want, got = tf.greedy_tokens(arch, monkeypatch, ctx)
    assert got.shape == (2, 5) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- VLM
def _vlm_and_dense():
    _, vlm = tf.models("qwen2-vl-2b")
    _, params = tf.weights("qwen2-vl-2b", "float32")
    return vlm, DenseLM(vlm.cfg), params


def test_vlm_default_ids_are_text_positions():
    """Without ids the VLM is the dense LM with RoPE, bit for bit, in the
    forward and in decode (ids from the cache's position)."""
    vlm, dense, params = _vlm_and_dense()
    toks = torch.from_numpy(tf.batch(vlm.cfg, S=12)["tokens"])
    with torch.no_grad():
        assert torch.equal(vlm.forward(params, toks, remat="none"),
                           dense.forward(params, toks, remat="none"))
        caches = [m.init_cache(2, 8, dtype=torch.float32, device="cpu")
                  for m in (vlm, dense)]
        for s in range(5):
            a, caches[0] = vlm.decode_step(params, caches[0], toks[:, s:s + 1])
            b, caches[1] = dense.decode_step(params, caches[1],
                                             toks[:, s:s + 1])
            assert torch.equal(a, b), s


def test_vlm_image_embeddings_replace_the_leading_positions():
    vlm, _, params = _vlm_and_dense()
    b = tf.batch(vlm.cfg, S=24)
    n = vlm.cfg.n_img_tokens
    img = torch.from_numpy(b["img_embeds"])
    toks = torch.from_numpy(b["tokens"])
    other = toks.clone()
    other[:, :n] = (other[:, :n] + 1) % vlm.cfg.vocab
    with torch.no_grad():
        a = vlm.forward(params, toks, img_embeds=img, remat="none")
        b2 = vlm.forward(params, other, img_embeds=img, remat="none")
        c = vlm.forward(params, other, remat="none")
    assert torch.equal(a, b2) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="do not fit"):
        vlm.forward(params, toks[:, :n - 1], img_embeds=img)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_and_axes_match_reference(arch):
    from repro.configs import SHAPES_BY_NAME as R_SHAPES
    from repro.configs import get_config as r_get_config
    from repro.models.registry import build_model as r_build
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    rm, pm = r_build(r_get_config(arch)), build_model(get_config(arch))
    for name, shape in SHAPES_BY_NAME.items():
        specs, rspecs = pm.input_specs(shape), rm.input_specs(R_SHAPES[name])
        assert list(specs) == list(rspecs), name
        for k in specs:
            assert specs[k].device.type == "meta"
            assert tuple(specs[k].shape) == rspecs[k].shape, (name, k)
            assert str(specs[k].dtype).split(".")[1] == \
                str(rspecs[k].dtype), (name, k)
        assert pm.input_axes(shape) == rm.input_axes(R_SHAPES[name]), name


def test_dense_mrope_path_matches_reference():
    """`DenseLM._qkv`'s M-RoPE branch (qwen2-vl reduced, explicit ids and
    image embeddings) through the dense class of both packages."""
    vlm, dense, params = _vlm_and_dense()
    rp, _ = tf.weights("qwen2-vl-2b", "float32")
    b = tf.batch(vlm.cfg, S=20, seed=8)
    rcm.set_unroll_scans(True)
    try:
        want = RDenseLM(vlm.cfg).forward(
            rp, jnp.asarray(b["tokens"]), mrope=jnp.asarray(b["mrope"]),
            img_embeds=jnp.asarray(b["img_embeds"]), remat="none")
    finally:
        rcm.set_unroll_scans(False)
    with torch.no_grad():
        got = dense.forward(params, torch.from_numpy(b["tokens"]),
                            mrope=torch.from_numpy(b["mrope"]),
                            img_embeds=torch.from_numpy(b["img_embeds"]),
                            remat="none")
    assert tf.rel(want, got) <= 1e-5
