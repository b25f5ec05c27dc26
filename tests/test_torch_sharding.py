"""The port's logical-axis sharding rules (`repro_torch.distributed.
sharding`) against the JAX package's: the rule table, `spec_for`,
`sanitize_spec` in both modes, `param_specs` of every config, the
production meshes; and `shard()` as a no-op off a mesh — it returns its
argument itself, and every family's forward, loss and decode step are
bit-equal with its sites stubbed out."""
import types

import numpy as np
import pytest
import torch

from repro.distributed import sharding as rsh
from repro.models import common as rcm
from repro.models.registry import build_model as r_build
from repro.configs import all_configs as r_all_configs
from repro_torch.configs import get_config as p_get_config
from repro_torch.distributed import sharding as psh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import common as pcm
from repro_torch.models.registry import build_model as p_build

ARCHS = sorted(r_all_configs())
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "small": ((4, 2), ("data", "model"))}
RULES = {"default": {}, "seq_shard": {"seq": "model", "embed_act": None},
         "batch_off": {"batch": None}}


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(kind):
    shape, axes = MESHES[kind]
    return types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, shape)))


def _tuple(p) -> tuple:
    """A reference PartitionSpec as the port's plain tuple."""
    return tuple(p)


def test_rule_table_matches_reference():
    assert psh.DEFAULT_RULES == rsh.DEFAULT_RULES
    assert psh.make_rules(seq="model") == rsh.make_rules(seq="model")


AXES = [("batch", "seq", "embed_act"), ("batch", "kv_seq", None, None),
        ("batch", "seq", "vocab"), ("vocab", "embed"),
        ("layers", "embed", "heads"), ("layers", "batch", "kv_seq", None,
                                       None),
        ("batch", None), (None, "batch", "seq"), ("blocks",),
        ("layers", "experts", "embed", "ffn"), ("frames", "conv")]


@pytest.mark.parametrize("mesh", [None, "single", "multi", "small"])
@pytest.mark.parametrize("rules", sorted(RULES))
def test_spec_for_matches_reference(mesh, rules):
    m = None if mesh is None else _mesh(mesh)
    r = psh.make_rules(**RULES[rules])
    for axes in AXES:
        assert psh.spec_for(axes, r, m) == _tuple(rsh.spec_for(axes, r, m))


@pytest.mark.parametrize("mesh", ["single", "multi", "small"])
@pytest.mark.parametrize("mode", ["arg", "constraint"])
def test_sanitize_spec_matches_reference(mesh, mode):
    m = _mesh(mesh)
    rng = np.random.default_rng(7)
    dims = [1, 2, 4, 12, 16, 40, 51865, 151936, 256, 4096, 1500]
    for axes in AXES:
        spec = psh.spec_for(axes, None, m)
        for _ in range(6):
            shape = tuple(int(rng.choice(dims)) for _ in axes)
            want = rsh.sanitize_spec(shape, rsh.spec_for(axes, None, m), m,
                                     mode=mode)
            assert psh.sanitize_spec(shape, spec, m, mode=mode) \
                == _tuple(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_structs_match_reference(arch):
    rdefs = r_build(r_all_configs()[arch]).param_defs()
    pdefs = p_build(p_get_config(arch)).param_defs()
    assert pdefs == rdefs
    for rules in RULES.values():
        r = psh.make_rules(**rules)
        got = pcm.param_specs(pdefs, r)
        want = rcm.param_specs(rdefs, r)
        assert got == {k: _tuple(v) for k, v in want.items()}
    structs = pcm.param_structs(pdefs)
    for k, s in rcm.param_structs(rdefs).items():
        assert tuple(structs[k].shape) == s.shape
        assert structs[k].dtype == torch.bfloat16 and structs[k].is_meta


def test_production_mesh_shapes():
    for multi, (shape, axes) in ((False, MESHES["single"]),
                                 (True, MESHES["multi"])):
        m = make_production_mesh(multi_pod=multi)
        assert m.axis_names == axes and m.devices.shape == shape
        assert m.shape == dict(zip(axes, shape))
        assert {d.type for d in m.devices.flat} == {"meta"}
    # arg_sharding/named_sharding return (mesh, spec)
    m = make_production_mesh()
    assert psh.arg_sharding(m, (51865, 1024), ("vocab", "embed")) == \
        (m, (None, "data"))
    assert psh.named_sharding(m, ("vocab", "embed")) == \
        (m, ("model", "data"))


def test_shard_without_a_mesh_returns_its_argument():
    x = torch.randn(2, 3, 4)
    assert psh.shard(x, ("batch", "seq", "embed_act")) is x
    assert psh._AMBIENT_MESH is None
    # a plain tensor under an ambient mesh is left as it is too
    with psh.mesh_context(_mesh("small")):
        assert psh.shard(x, ("batch", "seq", "embed_act")) is x
    assert psh._AMBIENT_MESH is None


FAMILIES = ["qwen2-1.5b", "qwen3-moe-235b-a22b", "xlstm-350m",
            "recurrentgemma-2b", "whisper-medium", "qwen2-vl-2b"]
SITES = ["transformer", "moe", "rglru", "whisper", "xlstm"]


def _run(arch):
    """Loss, logits and one decode step of `arch`'s reduced model."""
    cfg = p_get_config(arch).reduced()
    model = p_build(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.float32)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 9), generator=g)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.family == "whisper":
        batch["frames"] = torch.randn((2, cfg.n_frames, cfg.d_model),
                                      generator=g)
    loss = model.loss(params, batch, remat="none")
    with torch.no_grad():
        if cfg.family == "whisper":
            logits = model.forward(params, batch["tokens"], batch["frames"],
                                   remat="none")
        else:
            logits = model.forward(params, batch["tokens"], remat="none")
        cache = pcm.zeros_like_specs(model.cache_specs(2, 8, torch.float32),
                                     "cpu")
        step, _ = model.decode_step(params, cache, tokens[:, :1])
    return loss, logits, step


@pytest.mark.parametrize("arch", FAMILIES)
def test_shard_sites_are_bit_equal_no_ops(arch, monkeypatch):
    want = _run(arch)
    import importlib
    for name in SITES:
        mod = importlib.import_module(f"repro_torch.models.{name}")
        monkeypatch.setattr(mod, "shard", lambda x, *a, **k: x)
    got = _run(arch)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
