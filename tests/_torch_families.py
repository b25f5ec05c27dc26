"""Shared parts of the per-family tests of the port against the JAX
reference (`test_torch_moe_vlm.py`, `test_torch_recurrent.py`,
`test_torch_xlstm.py`, `test_torch_whisper.py`): the same `reduced()`
model built in both packages, the same weights in both, seeded numpy
batches with each family's extra inputs, and the loss/gradient/logit
and teacher-forced decode runs of both.

The weights are the port's seeded init (the reference's distributions),
carried into the reference with `repro_torch.training.convert`: the
reference's own init folds Python's `hash(path)` into its keys, which
changes from process to process, so its weights — and every error
measured on them — would change with each test worker.

The reference's fp32 runs go under `set_unroll_scans(True)`: its scanned
layers need a carry of one dtype, and the bf16 embedding turns into fp32
after the first residual when the weights are fp32 (ROADMAP queue 3).
The unrolled form is the reference's own dry-run lowering and computes
the same layers. Its runs are jitted with XLA's
`xla_allow_excess_precision` off: on (XLA's default), the compiled
program may skip the rounding of a bf16 cast, such as the embedding's,
and its fp32 RecurrentGemma then differs from its own op-by-op run by
about 3e-3 relative, its bf16 MoE routes some tokens differently
(ROADMAP queue 3).
"""
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as r_get_config
from repro.models import common as rcm
from repro.models.registry import build_model as r_build
from repro_torch.configs import get_config as p_get_config
from repro_torch.models.registry import build_model as p_build
from repro_torch.training.convert import tensor_to_numpy

DTYPES = ("float32", "bfloat16")
# jax.jit that keeps every rounding the program asks for (see above)
jit = functools.partial(
    jax.jit, compiler_options={"xla_allow_excess_precision": False})


def np32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def rel(a, b) -> float:
    """Relative norm of b - a against a."""
    a, b = np32(a), np32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def t(x, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def j(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x, np.float32)).astype(dtype)


@functools.lru_cache(maxsize=None)
def models(arch: str):
    """(reference, port) models of `arch`'s `reduced()` config."""
    return (r_build(r_get_config(arch).reduced()),
            p_build(p_get_config(arch).reduced()))


@functools.lru_cache(maxsize=None)
def weights(arch: str, dtype: str):
    """(reference params, port params): the port's init of seed 0 in
    `dtype`, and the reference's copy of it."""
    _, pm = models(arch)
    pp = pm.init(torch.Generator().manual_seed(0), getattr(torch, dtype))
    return ({k: jnp.asarray(tensor_to_numpy(v, bfloat16=jnp.bfloat16))
             for k, v in pp.items()}, pp)


def batch(cfg, B: int = 2, S: int = 32, seed: int = 0) -> dict:
    """Tokens and labels, plus the family's extra inputs: frames for
    whisper; image embeddings over the first n_img positions and M-RoPE
    ids for the VLM (the image on a square grid at t = 0, the text after
    it at t = h = w)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "whisper":
        out["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        n = cfg.n_img_tokens
        side = int(round(n ** 0.5))
        out["img_embeds"] = rng.standard_normal(
            (B, n, cfg.d_model)).astype(np.float32)
        i = np.arange(S)
        text = np.maximum(i - n + side, 0)
        ids = np.stack([np.where(i < n, 0, text),
                        np.where(i < n, (i // side) % side, text),
                        np.where(i < n, i % side, text)]).astype(np.int32)
        out["mrope"] = np.broadcast_to(ids[:, None], (3, B, S)).copy()
    return out


def _forward_kw(family: str, b: dict) -> dict:
    if family == "whisper":
        return {"frames": b["frames"]}
    if family in ("dense", "moe", "vlm"):
        return {k: b[k] for k in ("mrope", "img_embeds") if k in b}
    return {}


def ref_run(arch: str, dtype: str, b: dict):
    """The reference's (loss, {leaf: grad}, logits) on batch `b`."""
    rm, _ = models(arch)
    rp, _ = weights(arch, dtype)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    rcm.set_unroll_scans(dtype == "float32")
    try:
        loss, grads = jit(jax.value_and_grad(
            lambda p: rm.loss(p, jb, remat="none")))(rp)
        logits = jit(lambda p: rm.forward(
            p, jb["tokens"], remat="none",
            **_forward_kw(rm.cfg.family, jb)))(rp)
    finally:
        rcm.set_unroll_scans(False)
    return float(loss), grads, np32(logits)


def port_run(arch: str, dtype: str, b: dict, remat: str = "none"):
    """The port's (loss, {leaf: grad}, logits) on batch `b`."""
    _, pm = models(arch)
    _, pp = weights(arch, dtype)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in pp.items()}
    loss = pm.loss(leaves, tb, remat=remat)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    with torch.no_grad():
        logits = pm.forward(pp, tb["tokens"], remat="none",
                            **_forward_kw(pm.cfg.family, tb))
    return loss.item(), grads, logits


def ref_decode(arch: str, dtype: str, tokens: np.ndarray, S: int,
               frames=None):
    """Teacher-forced reference decode → ((B, T, V) logits, cache)."""
    rm, _ = models(arch)
    rp, _ = weights(arch, dtype)
    kw = {} if frames is None else {"params": rp,
                                    "frames": jnp.asarray(frames)}
    rcm.set_unroll_scans(dtype == "float32")
    try:
        cache = rm.init_cache(tokens.shape[0], S, getattr(jnp, dtype), **kw)
        step = jit(rm.decode_step)
        outs = []
        for i in range(tokens.shape[1]):
            lg, cache = step(rp, cache, jnp.asarray(tokens[:, i:i + 1]))
            outs.append(np32(lg))
        return np.stack(outs, 1), cache
    finally:
        rcm.set_unroll_scans(False)


def port_decode(arch: str, dtype: str, tokens: np.ndarray, S: int,
                frames=None, params=None):
    """Teacher-forced port decode → ((B, T, V) logits, cache)."""
    _, pm = models(arch)
    pp = weights(arch, dtype)[1] if params is None else params
    kw = {} if frames is None else {"params": pp,
                                    "frames": torch.from_numpy(frames)}
    cache = pm.init_cache(tokens.shape[0], S, dtype=getattr(torch, dtype),
                          device="cpu", **kw)
    outs = []
    with torch.no_grad():
        for i in range(tokens.shape[1]):
            lg, cache = pm.decode_step(pp, cache,
                                       torch.from_numpy(tokens[:, i:i + 1]))
            outs.append(lg)
    return torch.stack(outs, 1), cache


def fp32_init_cache(model, dtype):
    """`init_cache` with an fp32 default: fp32 weights need an fp32
    cache in both packages (ROADMAP queue 3)."""
    return functools.partial(type(model).init_cache, model, dtype=dtype)


def greedy_tokens(arch: str, monkeypatch, ctx: np.ndarray, new: int = 5):
    """fp32 greedy tokens of both packages' `ServeSession.generate`."""
    from repro.serving.serve_step import ServeConfig as RServeConfig
    from repro.serving.serve_step import ServeSession as RServeSession
    from repro_torch.serving import ServeConfig, ServeSession
    rm, pm = models(arch)
    rp, pp = weights(arch, "float32")
    monkeypatch.setattr(rm, "init_cache", fp32_init_cache(rm, jnp.float32))
    monkeypatch.setattr(pm, "init_cache", fp32_init_cache(pm, torch.float32))
    cfg = dict(max_seq=ctx.shape[1] + new, max_new_tokens=new)
    rcm.set_unroll_scans(True)
    try:
        want = RServeSession(rm, rp, RServeConfig(**cfg)).generate(
            jnp.asarray(ctx))
    finally:
        rcm.set_unroll_scans(False)
    got = ServeSession(pm, pp, ServeConfig(**cfg)).generate(
        torch.from_numpy(ctx))
    return np.asarray(want), got
