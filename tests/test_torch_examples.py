"""The port's examples (`examples/*_torch.py`) and its CI lane
(`scripts/ci_torch.sh`) on the CPU, each in a subprocess at small sizes
with one intra-op thread: every example runs to its last step, prints
its success lines and ends with one JSON line of the kernels' launch
counts (0 here: on the CPU the wrappers run the plain versions); rows an
example prints are held against the source FASTQ's bytes. The lane runs
its smokes (`--no-tests --device cpu`). On the card the same examples
run in `chip_smoke.py`'s `examples` phase."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.data.fastq import make_fastq

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")

EXAMPLES = {
    "quickstart": (["--reads", "300", "--sample-kib", "32"],
                   ["3 reads in one decode", "bit-perfect, touched",
                    "whole-file decode: bit-perfect"]),
    "serve_compressed_resident": (
        ["--reads", "300", "--sample-kib", "32", "--new-tokens", "2"],
        ["corpus resident compressed", "context fetch", "generated 2 tokens"]),
    "train_compressed_resident": (
        ["--steps", "4", "--batch", "2", "--seq", "32", "--reads", "300"],
        ["family=dense", "device-resident", "done; checkpoints in",
         "(latest step 4)"]),
    "elastic_restart": (
        ["--reads", "300", "--devices", "4", "--steps", "3"],
        ["devices: 4", "restored step 3 onto 2 device(s)",
         "post-restore batch stream bit-identical across the reshard",
         "resumed; step 8 loss="]),
}


def _reads(n_reads: int):
    """The source FASTQ's records (4 lines each) of `make_fastq` as the
    examples make it."""
    lines = make_fastq("platinum", n_reads=n_reads, seed=0).split(b"\n")
    return [b"\n".join(lines[4 * i:4 * i + 4]) for i in range(n_reads)]


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    flags, expect = EXAMPLES[name]
    extra = (["--ckpt-dir", str(tmp_path / "ckpt")]
             if name == "train_compressed_resident" else [])
    run = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}_torch.py"),
         "--device", "cpu", *flags, *extra], capture_output=True, text=True,
        cwd=ROOT, env=ENV, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    out = run.stdout.splitlines()
    for line in expect:
        assert any(line in o for o in out), (line, out)
    last = json.loads(out[-1])
    assert last["device"] == "cpu"
    assert last["launches"] == {"rans_decode": 0, "lz77_match": 0}
    reads = _reads(300)
    if name == "quickstart":
        (line,) = [o for o in out if o.startswith("read SRR0.")]
        rid = int(line.split(":")[0][len("read SRR0."):])
        header = reads[rid].split(b"\n")[0].decode()
        assert line.startswith(f"read SRR0.{rid}: {header} ")
    if name == "serve_compressed_resident":
        rows = [o for o in out if o.startswith("  read ")]
        assert len(rows) == 4
        for o in rows:
            rid = int(o.split(":")[0].split()[-1])
            ctx = ast.literal_eval(o.split("context=")[1].split("...")[0])
            assert ctx == reads[rid][:20], (rid, ctx)


def test_ci_lane_parses_and_runs_its_smokes_on_the_cpu():
    lane = ROOT / "scripts" / "ci_torch.sh"
    subprocess.run(["bash", "-n", str(lane)], check=True)
    run = subprocess.run(["bash", str(lane), "--no-tests", "--device", "cpu"],
                         capture_output=True, text=True, cwd=ROOT, env=ENV,
                         timeout=300)
    assert run.returncode == 0, (run.stdout[-2000:], run.stderr[-3000:])
    out = run.stdout
    assert "5/5 scenarios passed" in out
    assert "sharded smoke OK" in out
    assert out.rstrip().endswith("ci_torch: OK (cpu)")
