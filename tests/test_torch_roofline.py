"""The port's roofline (`repro_torch.roofline`) against the JAX package's:
`active_params` and the model FLOPs of every config and runnable shape,
`RooflineTerms` (the H100 constants set to the reference's for the
comparison), the collective sum, the link collectives take, and the
report and compare text on the same records (the compute-bound advice
reads "tensor-core-align" where the reference says "MXU-align")."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.configs import all_configs as r_all_configs
from repro.roofline import hlo_costs as rhc
from repro.roofline import report as rrep
from repro_torch.configs import all_configs as p_all_configs
from repro_torch.configs import get_config as p_get_config
from repro_torch.roofline import hlo_costs as phc
from repro_torch.roofline import report as prep

ARCHS = sorted(r_all_configs())
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_and_model_flops_match_reference(arch):
    rc, pc = r_all_configs()[arch], p_all_configs()[arch]
    assert phc.active_params(pc) == rhc.active_params(rc)
    assert phc.active_params(pc.reduced()) == rhc.active_params(rc.reduced())
    shapes = [s.name for s in rc.runnable_shapes()]
    assert shapes == [s.name for s in pc.runnable_shapes()]
    for s in rc.runnable_shapes():
        assert (phc.model_flops_train(pc, s.global_batch * s.seq_len)
                == rhc.model_flops_train(rc, s.global_batch * s.seq_len))
        assert (phc.model_flops_decode(pc, s.global_batch, s.seq_len)
                == rhc.model_flops_decode(rc, s.global_batch, s.seq_len))


def test_h100_constants_and_links():
    assert (phc.PEAK_FLOPS, phc.HBM_BW) == (989e12, 3.35e12)
    assert (phc.NVLINK_BW, phc.INTER_HOST_BW) == (450e9, 50e9)
    # on the production meshes every axis group crosses hosts of 8, so
    # collectives go at the inter-host rate
    assert phc.ICI_BW == phc.INTER_HOST_BW
    t = phc.RooflineTerms(flops=1.0, bytes_accessed=1.0,
                          coll_bytes={"all-gather": 5e9}, n_devices=256)
    assert t.collective_s == 5e9 / phc.INTER_HOST_BW


def test_collective_bytes_sums_the_five_kinds():
    got = phc.collective_bytes([("all-gather", 10), ("all-reduce", 4),
                                ("all-gather", 6), ("all-to-all", 1)])
    assert got == {"all-gather": 16, "all-reduce": 4, "reduce-scatter": 0,
                   "all-to-all": 1, "collective-permute": 0}
    assert set(got) == set(rhc.collective_bytes(""))


@pytest.mark.parametrize("flops,nbytes,coll", [
    (3.1e13, 2.0e11, {"all-gather": 7e9, "all-reduce": 0}),
    (1e9, 5e12, {"reduce-scatter": 1}),
    (4e14, 1e10, {"all-to-all": 9e12})])
def test_roofline_terms_match_reference_at_equal_constants(
        monkeypatch, flops, nbytes, coll):
    for k in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(phc, k, getattr(rhc, k))
    kw = dict(flops=flops, bytes_accessed=nbytes, coll_bytes=coll,
              n_devices=256, model_flops=2.2e16)
    want = rhc.RooflineTerms(**kw)
    got = phc.RooflineTerms(**kw)
    assert got.to_dict() == want.to_dict()
    assert got.total_coll_bytes == want.total_coll_bytes


def test_mfu():
    cfg = p_get_config("qwen2-1.5b")
    mf = phc.model_flops_train(cfg, 8 * 255)
    assert phc.mfu(mf, 0.2647) == mf / (0.2647 * 989e12)
    assert 0 < phc.mfu(mf, 0.2647) < 1


def _records():
    recs = []
    for i, (arch, shape) in enumerate([("qwen2-1.5b", "train_4k"),
                                       ("qwen2-1.5b", "decode_32k"),
                                       ("yi-6b", "prefill_32k"),
                                       ("xlstm-350m", "long_500k")]):
        for mesh in ("single", "multi"):
            t = rhc.RooflineTerms(
                flops=10.0 ** (11 + i), bytes_accessed=10.0 ** (13 - i),
                coll_bytes={"all-gather": 3e9 * (i + 1),
                            "all-reduce": 1e9 * (3 - i)},
                n_devices=256 if mesh == "single" else 512,
                model_flops=1e16 * (i + 1))
            recs.append({"arch": arch, "shape": shape, "mesh": mesh,
                         "remat": "full", "compile_s": 1.5 + i,
                         "memory_analysis": {
                             "argument_size_in_bytes": 7e9 + i,
                             "temp_size_in_bytes": 3e9 * i},
                         **t.to_dict(), "ok": True})
    recs.append({"arch": "grok-1-314b", "shape": "train_4k",
                 "mesh": "multi", "remat": "full", "ok": False,
                 "error": "RuntimeError('out of patience')"})
    return recs


def test_report_tables_match_reference(tmp_path):
    recs = _records()
    path = tmp_path / "dryrun_a.json"
    path.write_text(json.dumps(recs))
    got = prep.load_records([str(path)])
    assert got == rrep.load_records([str(path)])
    assert prep.fmt_dryrun_table(got) == rrep.fmt_dryrun_table(got)
    for mesh in ("single", "multi"):
        want = rrep.fmt_table(got, mesh)
        assert "MXU-align shapes" in want
        assert prep.fmt_table(got, mesh) == want.replace(
            "MXU-align shapes", "tensor-core-align shapes")
    for r in got:
        if r.get("ok"):
            assert prep.advice(r) == rrep.advice(r).replace(
                "MXU-align", "tensor-core-align")


def _run(module, *argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", module, *argv],
                          capture_output=True, text=True, check=True,
                          cwd=ROOT, env=env).stdout


def test_report_and_compare_main_match_reference(tmp_path):
    recs = _records()
    base = tmp_path / "base.json"
    base.write_text(json.dumps(recs))
    faster = [dict(r, step_time_s=r["step_time_s"] / 2,
                   roofline_fraction=r["roofline_fraction"] * 2)
              if r.get("ok") else r for r in recs]
    opt = tmp_path / "opt.json"
    opt.write_text(json.dumps(faster))
    want = _run("repro.roofline.report", str(base))
    got = _run("repro_torch.roofline.report", str(base))
    assert got == want.replace("MXU-align shapes", "tensor-core-align shapes")
    assert "7/9 cells ok" not in got and "8/9 cells ok" in got
    assert (_run("repro_torch.roofline.compare", str(base), str(opt))
            == _run("repro.roofline.compare", str(base), str(opt)))


def test_report_prints_the_ports_fallbacks(tmp_path):
    """Records of the port's dry-run carry `fallbacks`; `report` prints
    them in a table of their own (the reference's records have none, so
    its output stays the reference's)."""
    recs = _records()
    for i, r in enumerate(recs):
        if r.get("ok"):
            r["fallbacks"] = {k: {"count": i, "bytes": 1e9 * i}
                              for k in ("masked", "replicate", "whole")}
    table = prep.fmt_fallback_table(recs).splitlines()
    assert table[0] == ("| arch | shape | mesh | masked | replicate | "
                        "whole | fallback_GB/dev | share_of_coll |")
    row = next(ln for ln in table
               if ln.startswith("| qwen2-1.5b | decode_32k | multi |"))
    r = next(r for r in recs if (r["arch"], r["shape"], r["mesh"])
             == ("qwen2-1.5b", "decode_32k", "multi"))
    n = r["fallbacks"]["whole"]["count"]
    coll = sum(r["coll_bytes_per_device"].values())
    assert row == (f"| qwen2-1.5b | decode_32k | multi | {n} | {n} | {n} "
                   f"| {3 * n:.2f} | {3e9 * n / coll:.3f} |")
    path = tmp_path / "dryrun_f.json"
    path.write_text(json.dumps(recs))
    out = _run("repro_torch.roofline.report", str(path))
    assert "## Fallbacks" in out and row in out


def test_count_step_on_the_cpu_equals_the_meta_count():
    """`count_step` of a reduced train step on CPU tensors counts the
    FLOPs the same step counts on meta tensors, and refuses a card it
    does not have."""
    import torch
    from repro_torch.models.registry import build_model
    from repro_torch.roofline.step import (count_step, meta_like,
                                           step_roofline)
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    cfg = p_get_config("qwen2-1.5b").reduced()
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             AdamWConfig())
    toks = torch.randint(0, 256, (2, 17), generator=torch.Generator()
                         .manual_seed(1))
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(model, AdamWConfig(), remat="none")
    cpu = count_step(step, state, b, device="cpu")
    meta = count_step(step, *meta_like((state, b)), device="meta")
    assert cpu["flops"] == meta["flops"] > 0
    # bytes may differ by a scalar or two (a CPU scalar against a meta
    # one): they are reported, not held
    assert cpu["bytes"] > 0 and meta["bytes"] > 0
    r = step_roofline(phc.model_flops_train(cfg, 32), cpu, 0.01)
    assert r["bound_by"] in ("compute", "memory")
    assert r["roofline_ms"] == max(r["compute_ms"], r["memory_ms"])
    with pytest.raises(ValueError, match="lies on"):
        count_step(step, state, b, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            count_step(step, state, b)
