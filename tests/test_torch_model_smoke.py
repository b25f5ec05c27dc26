"""`tests/test_models_smoke.py` on the port: for every one of the ten
configs at `reduced()`, one train step (finite loss, a finite gradient
that is not zero) and one decode step (logits of the vocab's width, the
position advanced), with the reference's batches (frames for whisper,
image embeddings and M-RoPE ids for the VLM) made in torch from a seed;
and both launchers with the new families on the CPU. No JAX here."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCHS, all_configs, get_config
from repro_torch.models.registry import build_model
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, B=2, S=32):
    tokens = (torch.arange(B * S).reshape(B, S) * 7 % cfg.vocab).to(
        torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    g = torch.Generator().manual_seed(1)
    if cfg.family == "whisper":
        batch["frames"] = torch.randn((B, cfg.n_frames, cfg.d_model),
                                      generator=g)
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.randn((B, cfg.n_img_tokens, cfg.d_model),
                                          generator=g)
        p = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
        batch["mrope"] = torch.stack([p, p, p])
    return batch


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_smoke(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state = init_train_state(model, torch.Generator().manual_seed(0), opt)
    before = {k: v.clone() for k, v in state["params"].items()}
    batch = _batch(cfg)
    state, m = make_train_step(model, opt, remat="full")(state, batch)
    assert m["loss"].shape == () and bool(torch.isfinite(m["loss"]))
    gn = float(m["grad_norm"])
    assert np.isfinite(gn) and gn > 0
    assert any(not torch.equal(before[k], v)
               for k, v in state["params"].items())


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_step_smoke(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    B = 2
    batch = _batch(cfg)
    kw = ({"params": params, "frames": batch["frames"]}
          if cfg.family == "whisper" else {})
    cache = model.init_cache(B, 16, device="cpu", **kw)
    with torch.no_grad():
        logits, cache2 = model.decode_step(params, cache,
                                           batch["tokens"][:, :1])
    assert logits.shape == (B, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert int(cache2["pos"][0]) == 1


def test_all_archs_registered():
    cfgs = all_configs()
    assert set(ALL_ARCHS) == set(cfgs)
    m = cfgs["qwen3-moe-235b-a22b"]
    assert (m.n_layers, m.n_experts, m.top_k) == (94, 128, 8)
    r = cfgs["recurrentgemma-2b"]
    assert r.layer_pattern == ("rec", "rec", "attn") and r.n_kv_heads == 1


def _launch(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module, "--device", "cpu",
                           *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)


@pytest.mark.parametrize("arch", ["xlstm-350m", "qwen2-vl-2b"])
def test_train_launcher_takes_the_family(arch, tmp_path):
    """`--arch` takes every config; xLSTM's chunk needs T % min(128, T)
    == 0, so T = 32. (Whisper's loss reads frames, which the archive's
    batches lack: it raises KeyError, as the reference's does;
    test_torch_whisper.py holds that.)"""
    res = _launch("repro_torch.launch.train", "--arch", arch, "--reduced",
                  "--steps", "2", "--batch", "2", "--seq", "32", "--reads",
                  "200", "--block", "4096", "--prefetch", "0",
                  "--ckpt-dir", str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "training complete; 2" in res.stdout


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-medium"])
def test_serve_launcher_takes_the_family(arch):
    res = _launch("repro_torch.launch.serve", "--arch", arch, "--requests",
                  "2", "--ctx-bytes", "8", "--new-tokens", "2",
                  "--tune-sample-kb", "32", "--tune-target", "ratio",
                  "--tenants", "1")
    assert res.returncode == 0, res.stderr[-2000:]
    assert "2 requests × 2 tokens in" in res.stdout
