"""The port's model serving against the JAX reference on the CPU: the
decode-time attention (`q_offset`, `kv_len`), the KV cache,
`forward(collect_kv=True)`, `DenseLM.decode_step`, `ServeSession`
(prime, greedy generate, `serve_reads` with and without an index), the
train → checkpoint → restore → serve lifecycle of `tests/test_system.py`,
and `python -m repro_torch.launch.serve` on the CPU.

Models are `qwen2-1.5b.reduced()`; weights are the reference's, carried
across with `repro_torch.training.convert`. Tolerances, measured on these
inputs (worst seen in brackets):
  * teacher-forced `decode_step` logits, relative norm per step: fp32
    1e-5 [5.1e-7], bf16 2e-2 [9.8e-3: bf16 products round differently];
    the caches' keys and values within the same bounds.
  * port decode against port forward: the reference test's
    atol = rtol = 1e-5 (bf16: bit-equal; fp32: 4.8e-7 absolute).
  * greedy tokens (fp32) and served contexts: equal.
The reference's fp32 decode runs under `set_unroll_scans(True)` with an
fp32 cache: its layer scan needs a carry of one dtype, and its cache
write needs the cache's dtype to be the keys' (ROADMAP queue 3).
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as r_get_config
from repro.core.encoder import encode as r_encode
from repro.core.residency import CompressedResidentStore as RStore
from repro.models import common as rcm
from repro.models.registry import build_model as r_build
from repro.serving.serve_step import ServeConfig as RServeConfig
from repro.serving.serve_step import ServeSession as RServeSession
from repro_torch.configs import get_config as p_get_config
from repro_torch.core.encoder import encode
from repro_torch.core.index import ReadIndex
from repro_torch.core.residency import CompressedResidentStore
from repro_torch.data.fastq import make_fastq
from repro_torch.models import common as pcm
from repro_torch.models.registry import build_model as p_build
from repro_torch.serving import ServeConfig, ServeSession
from repro_torch.training.convert import state_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _j(x, dtype):
    return jnp.asarray(np.asarray(x, np.float32)).astype(dtype)


TOL = {"float32": 1e-5, "bfloat16": 2e-2}


# ---------------------------------------------------------- attention
ATTN_CASES = {
    # a decode step: one query against a cache, rows of different lengths
    "decode_kv_len": dict(Sq=1, q_offset=0, causal=False, window=0,
                          kv_len=[5, 11]),
    "offset_causal": dict(Sq=4, q_offset=6, causal=True, window=0,
                          kv_len=None),
    "offset_window": dict(Sq=4, q_offset=6, causal=True, window=3,
                          kv_len=None),
    "offset_kv_len": dict(Sq=4, q_offset=3, causal=True, window=0,
                          kv_len=[9, 5]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_q_offset_and_kv_len_match(case, dtype):
    c = ATTN_CASES[case]
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, c["Sq"], 6, 8))
    k, v = (rng.standard_normal((2, 12, 2, 8)) for _ in range(2))
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    kv_len = c["kv_len"]
    got = pcm.gqa_attention(
        _t(q, td), _t(k, td), _t(v, td), causal=c["causal"],
        window=c["window"], q_offset=c["q_offset"],
        kv_len=None if kv_len is None
        else torch.tensor(kv_len, dtype=torch.int32))
    want = rcm.gqa_attention(
        _j(q, jd), _j(k, jd), _j(v, jd), causal=c["causal"],
        window=c["window"], q_offset=c["q_offset"],
        kv_len=None if kv_len is None
        else jnp.asarray(kv_len, jnp.int32))
    assert got.dtype == td
    # fp32: 1e-5; bf16: fp32 softmax and products rounded to bf16 once,
    # so two bf16 ulps of the largest output
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got.float()), _np(want), atol=2e-2)


def test_kv_len_masks_the_cache_tail_and_skips_blockwise():
    """Keys at or past kv_len do not count, whatever they hold; and the
    blockwise switch leaves a kv_len call on the full path."""
    rng = np.random.default_rng(12)
    q = _t(rng.standard_normal((2, 1, 4, 8)), torch.float32)
    k, v = (_t(rng.standard_normal((2, 8, 2, 8)), torch.float32)
            for _ in range(2))
    kv_len = torch.tensor([3, 8], dtype=torch.int32)
    want = pcm.gqa_attention(q, k, v, causal=False, kv_len=kv_len)
    k2, v2 = k.clone(), v.clone()
    k2[0, 3:] = 1e4
    v2[0, 3:] = -7.0
    pcm.set_attn_impl("blockwise", 4)
    try:
        got = pcm.gqa_attention(q, k2, v2, causal=False, kv_len=kv_len)
    finally:
        pcm.set_attn_impl("full")
    assert torch.equal(got, want)
    short = pcm.gqa_attention(q[:1], k[:1, :3], v[:1, :3], causal=False)
    torch.testing.assert_close(got[:1], short, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ KV cache
def test_kv_cache_specs_and_init_match_reference():
    args = (3, 10, 2, 16, 4)
    for pd, jd in ((torch.bfloat16, jnp.bfloat16),
                   (torch.float32, jnp.float32)):
        got = pcm.init_kv_cache(*args, dtype=pd, device="cpu")
        want = rcm.init_kv_cache(*args, dtype=jd)
        specs = pcm.kv_cache_specs(*args, dtype=pd)
        rspecs = rcm.kv_cache_specs(*args, dtype=jd)
        assert set(got) == set(want) == set(specs) == {"k", "v", "pos"}
        for k in want:
            assert tuple(got[k].shape) == want[k].shape == \
                tuple(specs[k].shape) == rspecs[k].shape
            assert str(got[k].dtype).split(".")[1] == str(want[k].dtype)
            assert specs[k].dtype == got[k].dtype
            assert specs[k].device.type == "meta"
            assert not got[k].any()
    assert pcm.KV_CACHE_AXES == rcm.KV_CACHE_AXES


# ------------------------------------------------------------ DenseLM
@pytest.fixture(scope="module")
def models():
    return (r_build(r_get_config("qwen2-1.5b").reduced()),
            p_build(p_get_config("qwen2-1.5b").reduced()))


@pytest.fixture(scope="module")
def weights(models):
    """The reference's weights in both dtypes, and the port's copies."""
    rm, _ = models
    out = {}
    for dtype in ("float32", "bfloat16"):
        rp = rm.init(jax.random.key(0), getattr(jnp, dtype))
        out[dtype] = (rp, state_from_numpy(
            {k: np.asarray(v) for k, v in rp.items()}, "cpu")["params"])
    return out


TOKENS = (np.arange(12).reshape(2, 6) * 13 % 512).astype(np.int32)


def test_cache_methods_match_reference(models):
    rm, pm = models
    specs, rspecs = pm.cache_specs(2, 16), rm.cache_specs(2, 16)
    assert {k: tuple(v.shape) for k, v in specs.items()} == \
        {k: v.shape for k, v in rspecs.items()}
    assert pm.cache_axes() == rm.cache_axes()
    c = pm.init_cache(2, 16, device="cpu")
    assert c["k"].dtype == torch.bfloat16 and c["pos"].dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_collect_kv_matches_reference(models, weights, dtype):
    rm, pm = models
    rp, pp = weights[dtype]
    rcm.set_unroll_scans(dtype == "float32")
    try:
        rlog, (rk, rv) = rm.forward(rp, jnp.asarray(TOKENS), remat="none",
                                    collect_kv=True)
    finally:
        rcm.set_unroll_scans(False)
    with torch.no_grad():
        log, (k, v) = pm.forward(pp, torch.from_numpy(TOKENS), remat="none",
                                 collect_kv=True)
        plain = pm.forward(pp, torch.from_numpy(TOKENS), remat="none")
    assert tuple(k.shape) == rk.shape == tuple(v.shape) == rv.shape
    assert k.dtype == getattr(torch, dtype)
    assert torch.equal(log, plain)
    assert _rel(rlog, log.float()) <= TOL[dtype]
    assert _rel(rk, k.float()) <= TOL[dtype]
    assert _rel(rv, v.float()) <= TOL[dtype]


def _ref_decode(rm, rp, tokens, S, dtype):
    """Teacher-forced reference decode → ((B, T, V) logits, cache)."""
    rcm.set_unroll_scans(dtype == "float32")
    try:
        cache = rm.init_cache(tokens.shape[0], S, getattr(jnp, dtype))
        step = jax.jit(rm.decode_step)
        outs = []
        for t in range(tokens.shape[1]):
            lg, cache = step(rp, cache, jnp.asarray(tokens[:, t:t + 1]))
            outs.append(lg)
        return np.stack([_np(o) for o in outs], 1), cache
    finally:
        rcm.set_unroll_scans(False)


def _port_decode(pm, pp, tokens, S, dtype):
    cache = pm.init_cache(tokens.shape[0], S, dtype=getattr(torch, dtype),
                          device="cpu")
    outs = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            lg, cache = pm.decode_step(pp, cache,
                                       torch.from_numpy(tokens[:, t:t + 1]))
            outs.append(lg)
    return torch.stack(outs, 1), cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_logits_match_reference(models, weights, dtype):
    rm, pm = models
    rp, pp = weights[dtype]
    want, rcache = _ref_decode(rm, rp, TOKENS, 16, dtype)
    got, cache = _port_decode(pm, pp, TOKENS, 16, dtype)
    assert got.dtype == getattr(torch, dtype)
    for t in range(TOKENS.shape[1]):
        assert _rel(want[:, t], got[:, t].float()) <= TOL[dtype], t
    for k in ("k", "v"):
        assert cache[k].dtype == getattr(torch, dtype)
        assert _rel(rcache[k].astype(jnp.float32), cache[k].float()) \
            <= TOL[dtype], k
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(rcache["pos"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_forward(models, dtype):
    """Teacher-forced decode equals the parallel forward — the cache,
    RoPE positions and kv_len masking, as the reference's test holds its
    own (bit-equal in bf16 on the CPU)."""
    _, pm = models
    params = pm.init(torch.Generator().manual_seed(0), getattr(torch, dtype))
    dec, _ = _port_decode(pm, params, TOKENS, 16, dtype)
    with torch.no_grad():
        fwd = pm.forward(params, torch.from_numpy(TOKENS), remat="none")
    np.testing.assert_allclose(_np(dec.float()), _np(fwd.float()),
                               atol=1e-5, rtol=1e-5)


def test_decode_write_clamps_at_the_cache_end(models, weights):
    """Past a 4-slot cache the write lands on the last slot, as the
    reference's dynamic_update_slice clamps it, with no host read of
    pos."""
    rm, pm = models
    rp, pp = weights["float32"]
    want, rcache = _ref_decode(rm, rp, TOKENS, 4, "float32")
    got, cache = _port_decode(pm, pp, TOKENS, 4, "float32")
    assert int(cache["pos"][0]) == 6
    for t in range(TOKENS.shape[1]):
        assert _rel(want[:, t], got[:, t]) <= TOL["float32"], t
    for k in ("k", "v"):
        assert _rel(rcache[k], cache[k]) <= TOL["float32"], k


def test_decode_step_mrope_names_its_slice(models, weights):
    """`decode_step` takes M-RoPE ids: ids of t = h = w equal to the
    cache's position give the RoPE step bit for bit."""
    _, pm = models
    params = weights["float32"][1]
    caches = [pm.init_cache(2, 4, dtype=torch.float32, device="cpu")
              for _ in range(2)]
    for t in range(3):
        tok = torch.from_numpy(TOKENS[:, t:t + 1])
        ids = caches[0]["pos"][None, :, None].expand(3, 2, 1)
        with torch.no_grad():
            a, caches[0] = pm.decode_step(params, caches[0], tok, mrope=ids)
            b, caches[1] = pm.decode_step(params, caches[1], tok)
        assert torch.equal(a, b), t


# ------------------------------------------------------- ServeSession
def _fp32_cache(model, dtype):
    """`init_cache` with an fp32 default (see the module docstring)."""
    return functools.partial(type(model).init_cache, model, dtype=dtype)


def test_generate_tokens_equal_reference_fp32(models, weights, monkeypatch):
    rm, pm = models
    rp, pp = weights["float32"]
    monkeypatch.setattr(rm, "init_cache", _fp32_cache(rm, jnp.float32))
    monkeypatch.setattr(pm, "init_cache", _fp32_cache(pm, torch.float32))
    ctx = np.random.default_rng(3).integers(0, 256, (2, 8)).astype(np.int32)
    cfg = dict(max_seq=16, max_new_tokens=5)
    rcm.set_unroll_scans(True)
    try:
        want = RServeSession(rm, rp, RServeConfig(**cfg)).generate(
            jnp.asarray(ctx))
    finally:
        rcm.set_unroll_scans(False)
    sess = ServeSession(pm, pp, ServeConfig(**cfg))
    got = sess.generate(torch.from_numpy(ctx))
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    assert got.shape == (2, 5)
    np.testing.assert_array_equal(got, np.asarray(want))
    # prime's logits are the last context step's
    st = sess.prime(torch.from_numpy(ctx))
    assert int(st["cache"]["pos"][0]) == 8
    assert st["logits"].shape == (2, pm.cfg.vocab)


@pytest.fixture(scope="module")
def stores():
    data = make_fastq("platinum", n_reads=120, seed=9)
    a, ra = encode(data, block_size=2048), r_encode(data, block_size=2048)
    from repro.api import GenomicArchive as RGA
    from repro_torch.api import GenomicArchive
    return data, {
        "index": (GenomicArchive.from_bytes(data, block_size=2048,
                                            device="cpu"),
                  RGA.from_bytes(data, block_size=2048, backend="ref")),
        "records": (CompressedResidentStore(a, device="cpu"),
                    RStore(ra, backend="ref"))}


@pytest.mark.parametrize("ctx_bytes", [40, 400])
@pytest.mark.parametrize("kind", ["index", "records"])
def test_serve_reads_contexts_match_reference(models, weights, stores,
                                              kind, ctx_bytes):
    """The contexts `serve_reads` hands to `generate`: read ids and named
    regions through the query plane, truncated or zero-padded to
    ctx_bytes (index), or fixed ctx_bytes records (no index)."""
    rm, pm = models
    data, st = stores
    store, rstore = st[kind]
    ids = [3, 17, 60, 3] + (["SRR0.5:2-30"] if kind == "index" else [])
    seen = {}
    sess = ServeSession(pm, weights["bfloat16"][1], ServeConfig(),
                        store=store)
    rsess = RServeSession(rm, weights["bfloat16"][0], RServeConfig(),
                          store=rstore)
    sess.generate = lambda c, n=None: seen.setdefault("port", c)
    rsess.generate = lambda c, n=None: seen.setdefault("ref", c)
    sess.serve_reads(ids, ctx_bytes=ctx_bytes)
    rsess.serve_reads(ids, ctx_bytes=ctx_bytes)
    got, want = seen["port"], np.asarray(seen["ref"])
    assert got.dtype == torch.int32 and got.shape == (len(ids), ctx_bytes)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "records":
        src = np.frombuffer(data, np.uint8)
        np.testing.assert_array_equal(
            got[1].numpy(), src[17 * ctx_bytes:18 * ctx_bytes])
    with pytest.raises(ValueError, match="store"):
        ServeSession(pm, weights["bfloat16"][1],
                     ServeConfig()).serve_reads([0], 8)


def test_end_to_end_compressed_resident_lifecycle(tmp_path):
    """`tests/test_system.py` on the port: compressed-resident data
    pipeline → train → compressed checkpoint → bit-perfect restore →
    serve batched requests by read id from the same corpus."""
    import warnings
    from repro_torch.checkpoint.checkpointer import (CheckpointConfig,
                                                     Checkpointer)
    from repro_torch.data.pipeline import (CompressedResidentDataLoader,
                                           PipelineConfig)
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    corpus = make_fastq("platinum", n_reads=500, seed=11)
    cfg = p_get_config("qwen2-1.5b").reduced()
    model = p_build(cfg)

    # 1. compressed-resident data pipeline
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        dl = CompressedResidentDataLoader(
            corpus, PipelineConfig(seq_len=48, batch_size=4,
                                   block_size=4096), device="cpu")
    stats = dl.store.stats()
    assert stats.compressed_device_bytes < stats.raw_size

    # 2. train a few steps
    opt = AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=40)
    state = init_train_state(model, torch.Generator().manual_seed(0), opt)
    step = make_train_step(model, opt, remat="none")
    first = last = None
    for i, batch in zip(range(12), dl):
        state, metrics = step(state, batch)
        if first is None:
            first = float(metrics["loss"])
        last = float(metrics["loss"])
    assert last < first

    # 3. compressed checkpoint + bit-perfect restore
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    ck.save(12, state, extra={"loader": dl.state_dict(), "step": 12})
    restored = ck.restore(device="cpu")
    restored.pop("_manifest")
    for k in state["params"]:
        assert torch.equal(state["params"][k], restored["params"][k]), k

    # 4. serve batched requests addressed by read id from the SAME corpus
    a = encode(corpus, block_size=4096)
    idx = ReadIndex.build(corpus, 4096)
    store = CompressedResidentStore(a, idx, device="cpu")
    sess = ServeSession(model, restored["params"],
                        ServeConfig(max_seq=64, max_new_tokens=4),
                        store=store)
    toks = sess.serve_reads([3, 17, 99], ctx_bytes=32)
    assert toks.shape == (3, 4)
    assert np.all(toks >= 0) and np.all(toks < cfg.vocab)


# ------------------------------------------------------------ launcher
def test_serve_launcher_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "4", "--ctx-bytes", "16", "--new-tokens", "3",
         "--tune-sample-kb", "32", "--tune-target", "ratio"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = res.stdout
    assert "tuned profile [ratio]: " in out
    assert "4 queued requests coalesced into 1 fetch(es)" in out
    assert "counts={'requests': 1, " in out
    assert "miss=0.000" in out and "region 'SRR0." in out
    assert "4 requests × 3 tokens in" in out and "tok/s on CPU)" in out


def test_serve_launcher_refuses_the_cpu_without_a_card(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.main(["--requests", "1"])
