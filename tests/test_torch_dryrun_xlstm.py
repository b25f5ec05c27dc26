"""xLSTM's dry-run counts against the reference's `cost_extrapolated`.

The reference fits its mLSTM chunk scan in two dimensions (depth and
chunk width) and adds `_slstm_analytic` for the sLSTM steps XLA counts
once; the port traces every step of its Python loops and fits depth and
sequence length instead (`launch/dryrun.py`). The two count different
things — XLA's `flops` include elementwise ops, DTensor chooses its own
placements — so the totals are held within a stated band, not equal:
the port's FLOPs within 0.25–4× the reference's (2.6× read on this cell:
DTensor replicates the reduced model's small products over the model
axis), and both positive. The reference runs in a subprocess (its
`launch/dryrun.py` forces 512 host devices when imported)."""
import dataclasses as dc
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
# reduced xLSTM, one group (3 mLSTM + 1 sLSTM), a 16-position chunk so
# both packages' fits stay short; B=8 × T=64 on a (4, 2) mesh
CHUNK, T, B = 16, 64, 8

REF = r'''
import json, sys, dataclasses as dc
from repro.launch import dryrun as D      # forces 512 host devices first
from repro.configs.base import register, ShapeConfig
from repro.configs import get_config
from repro.compat import make_mesh
chunk, T, B = (int(a) for a in sys.argv[2:5])
register(dc.replace(get_config("xlstm-350m").reduced(), name="xlstm-tiny",
                    n_layers=4, mlstm_chunk=chunk))
D.SHAPES_BY_NAME["tiny"] = ShapeConfig("tiny", T, B, "train")
out = D.cost_extrapolated("xlstm-tiny", "tiny",
                          make_mesh((4, 2), ("data", "model")), "full")
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
'''


@pytest.mark.slow
def test_xlstm_counts_against_reference_cost_extrapolated(tmp_path,
                                                          capsys):
    (tmp_path / "ref.py").write_text(REF)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, str(tmp_path / "ref.py"), str(tmp_path / "r.json"),
         str(CHUNK), str(T), str(B)], cwd=ROOT, env=env)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = dc.replace(get_config("xlstm-350m").reduced(), n_layers=4,
                         mlstm_chunk=CHUNK)
        mesh = make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
        got = dr.cost_extrapolated(cfg, ShapeConfig("tiny", T, B, "train"),
                                   mesh, "full")
    finally:
        torch.set_num_threads(n)
        assert ref.wait(timeout=600) == 0
    want = json.loads((tmp_path / "r.json").read_text())
    ratio = got["flops"] / want["flops"]
    with capsys.disabled():
        print(f"\nxLSTM port/reference: flops {ratio:.3f}, bytes "
              f"{got['bytes'] / want['bytes']:.3f}, collectives "
              f"{ {k[5:]: (got[k], want[k]) for k in want if k[:5] == 'coll_'} }")
    assert got["flops"] > 0 and want["flops"] > 0
    assert 0.25 <= ratio <= 4.0, ratio
