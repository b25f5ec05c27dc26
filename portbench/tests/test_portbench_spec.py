"""`BENCHMARK.json` against the benchmark's contract, the import rules,
and a configuration, a traffic kind and mix, a metric and a cell added
as files and entries alone (CPU)."""
import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"_dim$|_rank$|expansion|experts_per_tok|block_size|"
                   r"read_len)")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(SPEC["command"]) <= 32 and all(_line(w) for w in
                                               SPEC["command"])
    # a full check fits with the largest number of cells
    per_cell = 14 * (SPEC["run_seconds"] + 60) + 2 * 90
    assert 2 * (SPEC["run_seconds"] + 60) + 24 * per_cell + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(
            c["why"])
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        assert len(c["reduced"]) <= 16
        cfg = json.loads((ROOT / c["file"]).read_text())
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg and not WIDTH.search(k)
        names.append(c["name"])
    cfgs = set(names)
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").exists()
        names.append(w["name"])
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= ({"bound"} if m in SPEC["end_to_end"]
                    else {"layer", "moves"})
        assert set(m) <= allowed and NAME.match(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        names.append(m["name"])
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    assert len(names) == len(set(names))
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    for c in cells:
        mine = [m for m in SPEC["end_to_end"] if c in m.get("workloads",
                                                               cells)]
        assert len(mine) >= 2
        assert any(c in m.get("workloads", cells) for m in SPEC["per_layer"])


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "jaxtyping_like",
                 "portbench"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert [m for m in harness.banned_modules()
            if m not in ("jax", "jaxlib", "flax", "repro")] == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.banned_modules()


def _imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = [p for p in (ROOT / "portbench").rglob("*.py")
             if "tests" not in p.parts]
    assert files
    for p in files:
        assert not _imports(p) & set(harness.BANNED), p
    for p in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert not _imports(p) & {"repro_torch", "torch", "portbench"}, p


def test_measuring_entry_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without")
    r = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "err194147-ra16k.scan", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "no CUDA card" in r.stderr


NEW_KIND = '''"""hops: block ranges of `hop_blocks` blocks at starts drawn from
the seed, through fetch_block_range."""
import numpy as np


def check(traffic):
    assert int(traffic["hop_blocks"]) >= 1


def requests(traffic, ref, rng):
    n = int(traffic["hop_blocks"])
    while True:
        b = int(rng.integers(0, ref.n_blocks - n + 1))
        yield b, b + n


def entry(store):
    return lambda spec: store.fetch_block_range(*spec)


def size(spec, ref):
    return spec[1] - spec[0], (spec[1] - spec[0]) * ref.block_size


def record(spec):
    return None


def wrong_bytes(ref, spec, out):
    return int(np.count_nonzero(out != ref.block_rows(*spec)))
'''


def test_a_new_configuration_kind_mix_metric_and_cell_are_files_and_entries(
        tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    bench = tmp_path / "portbench"
    cfg = json.loads((bench / "configs" / "err194147-ra16k.json")
                     .read_text())
    cfg.update(name="tiny-ra16k", tiles=2, tile_blocks=3,
               raw_bytes=2 * 3 * cfg["block_size"])
    (bench / "configs" / "tiny-ra16k.json").write_text(json.dumps(cfg))
    (bench / "kinds" / "hops.py").write_text(NEW_KIND)
    (bench / "traffic" / "trickle.json").write_text(json.dumps(
        {"kind": "hops", "hop_blocks": 2, "in_flight": 1,
         "checked_requests": 2}))
    (bench / "metrics" / "requests_done.py").write_text(
        "def read(ctx):\n    return len(ctx.requests)\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-ra16k", "source": "a test",
                            "file": "portbench/configs/tiny-ra16k.json",
                            "reduced": ["raw_bytes"], "why": "a test"})
    spec["workloads"].append({"name": "tiny-ra16k.trickle",
                              "config": "tiny-ra16k", "traffic": "trickle",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "requests_done", "unit": "requests",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["tiny-ra16k.trickle"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    for p, b in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == b
    old = json.loads(before[tmp_path / "BENCHMARK.json"])
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert spec[key][:len(old[key])] == old[key]
    cell = harness.load_cell(tmp_path, "tiny-ra16k.trickle")
    worker = harness.HostSetup(tmp_path, cell.config, 2**31 + 11)
    try:
        host = worker.result(timeout=120)
    finally:
        worker.stop()
    res = harness.run(tmp_path, "tiny-ra16k.trickle", 2**31 + 11, 0.2,
                      False, host, device="cpu")
    assert res["correct"], res["checks"]
    assert res["checked_requests"] == min(2, res["attempted"])
    assert res["metrics"]["requests_done"]["value"] == res["attempted"] > 0
    assert set(res["metrics"]) == {"setup_s", "requests_done"}


def _kind(name):
    from portbench import generator
    return generator.load_kind(ROOT, {"kind": name, "in_flight": 1,
                                      "checked_requests": 1,
                                      "request_blocks": 1})


def test_scan_ranges_are_one_length_inside_the_archive_at_drifting_offsets():
    from portbench import generator
    from types import SimpleNamespace
    scan = _kind("scan")
    ref = SimpleNamespace(n_blocks=12)
    t = {"request_blocks": 5}
    g = scan.requests(t, ref, generator.rng_for(2**40 + 3, 1))
    seen = [next(g) for _ in range(12)]
    assert all(b1 - b0 == 5 and 0 <= b0 and b1 <= 12 for b0, b1 in seen)
    assert all(b == (a + 5) % 8 for (a, _), (b, _) in zip(seen, seen[1:]))
    assert {b0 % 5 for b0, _ in seen} == set(range(5))
    g2 = scan.requests(t, ref, generator.rng_for(2**40 + 3, 1))
    assert [next(g2) for _ in range(12)] == seen


@pytest.mark.parametrize("n_blocks,request_blocks", [(12, 5), (7, 7),
                                                      (100, 1)])
def test_scan_ranges_are_a_function_of_the_seed(n_blocks, request_blocks):
    from portbench import generator
    from types import SimpleNamespace
    scan = _kind("scan")
    ref = SimpleNamespace(n_blocks=n_blocks)
    t = {"request_blocks": request_blocks}
    a = scan.requests(t, ref, generator.rng_for(-5, 1))
    b = scan.requests(t, ref, generator.rng_for(-5, 1))
    x, y = [next(a) for _ in range(9)], [next(b) for _ in range(9)]
    assert x == y
    assert all(0 <= b0 < b1 <= n_blocks and b1 - b0 == request_blocks
               for b0, b1 in x)


def test_expected_bytes_depend_on_where_a_request_lies():
    """A tile of an odd number of blocks divides neither 2^32 bytes nor a
    scan request, so a stale range, another range's bytes or an offset
    wrapped at 32 bits reads other bytes than the reference's."""
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        tile_bytes = cfg["tile_blocks"] * cfg["block_size"]
        assert cfg["tile_blocks"] % 2 == 1 and (1 << 32) % tile_bytes
        for w in SPEC["workloads"]:
            t = json.loads((ROOT / "portbench" / "traffic"
                            / f"{w['traffic']}.json").read_text())
            if w["config"] == c["name"] and t["kind"] == "scan":
                assert t["request_blocks"] % cfg["tile_blocks"]


def test_unknown_traffic_kind_is_refused():
    from portbench import generator
    with pytest.raises(FileNotFoundError):
        generator.load_kind(ROOT, {"kind": "nope", "in_flight": 1,
                                   "checked_requests": 1})
    with pytest.raises(ValueError):
        generator.load_kind(ROOT, {"kind": "scan", "in_flight": 0,
                                   "checked_requests": 1,
                                   "request_blocks": 1})
