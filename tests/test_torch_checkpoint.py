"""The port's compressed checkpoints, mirroring `tests/test_checkpoint.py`
(bit-perfect restore, compression, keep-k, digest verification, extra
metadata, flatten/unflatten), plus the format held against the JAX
package: the same state saved by both gives equal manifest tensor
tables and byte-equal payloads, and a checkpoint written by either
package restores bit-equal in the other (bf16 and int32 scalars
included)."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.checkpointer import (CheckpointConfig as RConfig,
                                           Checkpointer as RCheckpointer)
from repro_torch.checkpoint.checkpointer import (CheckpointConfig,
                                                 Checkpointer, _flatten,
                                                 _unflatten)
from repro_torch.distributed.fault_tolerance import elastic_reshard
from repro_torch.training.convert import state_to_numpy, tensor_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_state(seed=0):
    """One state as numpy arrays (bf16 as jax's numpy dtype)."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": np.asarray(jnp.asarray(
            rng.standard_normal((64, 32)), jnp.bfloat16)),
            "b": np.arange(32, dtype=np.float32)},
        "opt": {"m": {"w": np.ones((64, 32), np.float32)},
                "step": np.asarray(7, np.int32)},
    }


def _torch_state(seed=0):
    return _map(_np_state(seed), lambda a: tensor_from_numpy(a, "cpu"))


def _jax_state(seed=0):
    return _map(_np_state(seed), jnp.asarray)


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _assert_equal_flat(a: dict, b: dict):
    """Two flattened states hold the same bits and dtypes."""
    fa, fb = _flatten(a), _flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype, k
            assert torch.equal(x, y), k
        else:
            xa = state_to_numpy(x, bfloat16=jnp.bfloat16) \
                if isinstance(x, torch.Tensor) else np.asarray(x)
            ya = state_to_numpy(y, bfloat16=jnp.bfloat16) \
                if isinstance(y, torch.Tensor) else np.asarray(y)
            assert xa.dtype == ya.dtype, (k, xa.dtype, ya.dtype)
            assert xa.shape == ya.shape, k
            assert xa.tobytes() == ya.tobytes(), k


def test_save_restore_bit_perfect(tmp_path):
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    st = _torch_state()
    ck.save(1, st)
    out = ck.restore(device="cpu")
    out.pop("_manifest")
    _assert_equal_flat(st, out)
    assert out["params"]["w"].dtype == torch.bfloat16
    assert out["opt"]["step"].shape == () and \
        out["opt"]["step"].dtype == torch.int32


def test_compression_actually_on(tmp_path):
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    st = {"params": {"w": torch.zeros((512, 512), dtype=torch.float32)}}
    d = ck.save(2, st)
    man = json.load(open(os.path.join(d, "manifest.json")))
    assert man["payload_ratio"] > 5.0


def test_keep_last_k(tmp_path):
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path), keep_last=2))
    for s in (1, 2, 3, 4):
        ck.save(s, _torch_state(s))
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path))
    assert steps == [3, 4]
    assert ck.latest_step() == 4


def test_digest_detects_corruption(tmp_path):
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path),
                                       compress=False))
    d = ck.save(1, _torch_state())
    p = os.path.join(d, "payload.bin")
    buf = bytearray(open(p, "rb").read())
    buf[10] ^= 0xFF
    open(p, "wb").write(bytes(buf))
    with pytest.raises(AssertionError, match="digest"):
        ck.restore(device="cpu")


def test_extra_metadata_roundtrip(tmp_path):
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    ck.save(5, _torch_state(), extra={"loader": {"step": 42, "seed": 0},
                                      "step": 5})
    out = ck.restore(device="cpu")
    assert out["_manifest"]["extra"]["loader"]["step"] == 42
    with pytest.raises(FileNotFoundError):
        Checkpointer(CheckpointConfig(
            directory=str(tmp_path / "empty"))).restore(device="cpu")


def test_flatten_unflatten_inverse():
    st = _torch_state()
    _assert_equal_flat(_unflatten(_flatten(st)), st)
    assert sorted(_flatten(st)) == ["opt.m.w", "opt.step", "params.b",
                                    "params.w"]


# -------------------------------------------- the format of the reference
@pytest.mark.parametrize("compress", [True, False])
def test_manifests_and_payloads_equal_the_reference(tmp_path, compress):
    pd, rd = str(tmp_path / "port"), str(tmp_path / "ref")
    Checkpointer(CheckpointConfig(directory=pd, compress=compress)).save(
        3, _torch_state(), extra={"step": 3})
    RCheckpointer(RConfig(directory=rd, compress=compress)).save(
        3, _jax_state(), extra={"step": 3})
    pm = json.load(open(os.path.join(pd, "step_00000003", "manifest.json")))
    rm = json.load(open(os.path.join(rd, "step_00000003", "manifest.json")))
    assert pm["tensors"] == rm["tensors"]
    assert list(pm) == list(rm)
    for k in ("step", "compress", "extra", "payload_ratio"):
        assert pm.get(k) == rm.get(k), k
    name = "payload.aceapex" if compress else "payload.bin"
    assert open(os.path.join(pd, "step_00000003", name), "rb").read() == \
        open(os.path.join(rd, "step_00000003", name), "rb").read()


@pytest.mark.parametrize("compress", [True, False])
def test_port_checkpoint_restores_in_the_reference(tmp_path, compress):
    st = _torch_state(1)
    Checkpointer(CheckpointConfig(directory=str(tmp_path),
                                  compress=compress)).save(
        9, st, extra={"step": 9, "loader": {"step": 9, "seed": 2}})
    out = RCheckpointer(RConfig(directory=str(tmp_path))).restore()
    man = out.pop("_manifest")
    assert man["extra"]["loader"] == {"step": 9, "seed": 2}
    assert out["params"]["w"].dtype == jnp.bfloat16
    assert out["opt"]["step"].dtype == jnp.int32
    _assert_equal_flat(_map(out, np.asarray), _np_state(1))


@pytest.mark.parametrize("compress", [True, False])
def test_reference_checkpoint_restores_in_the_port(tmp_path, compress):
    RCheckpointer(RConfig(directory=str(tmp_path), compress=compress)).save(
        4, _jax_state(2), extra={"step": 4})
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    out = ck.restore(device="cpu")
    assert out.pop("_manifest")["extra"]["step"] == 4
    _assert_equal_flat(out, _torch_state(2))
    again = elastic_reshard(ck, device="cpu")
    again.pop("_manifest")
    _assert_equal_flat(again, out)


def test_trained_state_roundtrips_both_ways(tmp_path):
    """A real train state (bf16 params, fp32 moments, int32 step) of the
    reduced model crosses both ways bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    model = build_model(get_config("qwen2-1.5b").reduced())
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5)
    state = init_train_state(model, torch.Generator().manual_seed(1), opt)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 17)).astype(np.int32))
    state, _ = make_train_step(model, opt, remat="none")(
        state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    Checkpointer(CheckpointConfig(directory=str(tmp_path / "p"))).save(
        1, state)
    ref = RCheckpointer(RConfig(directory=str(tmp_path / "p"))).restore()
    ref.pop("_manifest")
    _assert_equal_flat(_map(ref, np.asarray), state)
    RCheckpointer(RConfig(directory=str(tmp_path / "r"))).save(
        1, jax.tree.map(jnp.asarray, ref))
    back = Checkpointer(CheckpointConfig(
        directory=str(tmp_path / "r"))).restore(device="cpu")
    back.pop("_manifest")
    _assert_equal_flat(back, state)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-350m"])
def test_nested_family_state_roundtrips_both_ways(tmp_path, arch):
    """The reference's params of a non-dense family — the nested (G, RPG,
    …) RG-LRU stacks and its tail, or the (G, M, …) mLSTM stacks — and
    fresh AdamW state carried across with `state_from_numpy`, back with
    `state_to_numpy`, and through a checkpoint written by either package,
    bit for bit."""
    from repro.configs import get_config as r_get_config
    from repro.models.registry import build_model as r_build
    from repro_torch.training.convert import state_from_numpy
    rm = r_build(r_get_config(arch).reduced())
    rp = {k: np.asarray(v) for k, v in rm.init(jax.random.key(3)).items()}
    nested = [k for k in rp if k.startswith(("rec/", "m/"))]
    assert nested and all(rp[k].ndim >= 3 for k in nested)
    state = state_from_numpy(rp, "cpu")
    assert state["params"]["embed"].dtype == torch.bfloat16
    back = state_to_numpy(state["params"], bfloat16=jnp.bfloat16)
    for k, v in rp.items():
        assert back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes()
    Checkpointer(CheckpointConfig(directory=str(tmp_path / "p"))).save(
        2, state)
    ref = RCheckpointer(RConfig(directory=str(tmp_path / "p"))).restore()
    ref.pop("_manifest")
    _assert_equal_flat(_map(ref, np.asarray), state)
    RCheckpointer(RConfig(directory=str(tmp_path / "r"))).save(
        2, jax.tree.map(jnp.asarray, ref))
    out = Checkpointer(CheckpointConfig(
        directory=str(tmp_path / "r"))).restore(device="cpu")
    out.pop("_manifest")
    _assert_equal_flat(out, state)
