#!/usr/bin/env bash
# One-command lane of the PyTorch/CUDA port (src/repro_torch/).
#
#   scripts/ci_torch.sh                  # compileall + port tests + smokes on the card
#   scripts/ci_torch.sh --device cpu     # the same on the CPU (plain kernels)
#   scripts/ci_torch.sh --fast           # port tests without @pytest.mark.slow
#   scripts/ci_torch.sh --no-tests       # compileall + the smokes alone
#   scripts/ci_torch.sh -k dryrun        # any other argument goes to pytest
#
# In order: compileall of the port, its examples and chip_smoke.py; the
# port's tests against the JAX reference (tests/test_torch_*.py; they
# need JAX, which they keep on the host CPU, and a machine without it
# skips them with a note); the card
# tests (-m cuda tests/test_torch_cuda.py) when a card is present; then,
# on --device (default cuda, which refuses to start without a card), the
# trainer smoke through the launcher, the serving-plane and chaos
# smokes, and the sharded smoke on an emulated 8-device mesh (a mesh
# device may repeat, so one card or the CPU carries it).
#
# No bench gate yet: it comes with the port's benchmark, against a
# baseline file of its own.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

DEV=cuda FAST=0 TESTS=1
ARGS=()
while [ $# -gt 0 ]; do
  case "$1" in
    --device) DEV="$2"; shift ;;
    --device=*) DEV="${1#--device=}" ;;
    --fast) FAST=1 ;;
    --no-tests) TESTS=0 ;;
    *) ARGS+=("$1") ;;
  esac
  shift
done

python -m compileall -q src/repro_torch examples/*_torch.py chip_smoke.py

if [ "$TESTS" = 1 ]; then
  MARK=()
  if [ "$FAST" = 1 ]; then MARK=(-m "not slow"); fi
  if python -c "import importlib.util as u, sys; sys.exit(not u.find_spec('jax'))"; then
    # the reference runs on the host CPU only, never on a card
    JAX_PLATFORMS=cpu python -m pytest -x -q ${MARK[@]+"${MARK[@]}"} \
      tests/test_torch_*.py ${ARGS[@]+"${ARGS[@]}"}
  else
    echo "ci_torch: no JAX here: the port's tests against the reference skipped"
  fi
  if python -c "import sys, torch; sys.exit(not torch.cuda.is_available())"; then
    python -m pytest -x -q -m cuda tests/test_torch_cuda.py
  fi
fi

# end-to-end train smoke: tiny model, 4 steps through the full launcher —
# encode once + save the archive, async prefetch on, unrolled windows,
# checkpoint written. The compressed-resident data plane as a user
# invokes it.
TRAIN_TMP=$(mktemp -d)
trap 'rm -rf "$TRAIN_TMP"' EXIT
python -m repro_torch.launch.train --arch qwen2-1.5b --reduced --steps 4 \
  --batch 2 --seq 32 --reads 300 --block 4096 --prefetch 2 --unroll 2 \
  --archive "$TRAIN_TMP/corpus.acegad" --ckpt-every 4 \
  --ckpt-dir "$TRAIN_TMP/ckpt" --device "$DEV"

# serving-plane smoke: one closed loop through ServingFrontend with a
# bit-identity check of every request
python -m repro_torch.serving.traffic --smoke --device "$DEV"
# chaos smoke: every fault scenario through detect → recover → degrade;
# output bit-perfect or a typed error, nonzero on a silently wrong byte
python -m repro_torch.resilience.chaos --smoke --device "$DEV"
# sharded smoke: mesh-partitioned residency on an emulated 8-device mesh —
# partitioned decode bit-identical to the raw corpus, then a cached
# re-read through the per-shard block cache must report hits
CI_DEVICE="$DEV" python - <<'PYEOF'
import os

import numpy as np

from repro_torch.api.executors import ShardedExecutor
from repro_torch.api.plan import QueryPlanner
from repro_torch.core import encoder
from repro_torch.core.decoder import resolve_device
from repro_torch.core.residency import CompressedResidentStore
from repro_torch.core.sharded_decode import (partition_archive,
                                             partitioned_decode_blocks)
from repro_torch.data.fastq import make_fastq
from repro_torch.launch.mesh import make_mesh

dev = resolve_device(os.environ["CI_DEVICE"])
data = make_fastq("platinum", n_reads=400, seed=3)
a = encoder.encode(data, block_size=4096)
s = CompressedResidentStore(a, device=dev)
mesh = make_mesh((8,), ("data",), [dev] * 8)
part = partition_archive(s.decoder, mesh)
rows = partitioned_decode_blocks(s.decoder, part, np.arange(a.n_blocks))
rows = rows.cpu().numpy()
assert rows.reshape(-1)[:len(data)].tobytes() == data, "partition mismatch"
assert part.per_shard_device_bytes * 8 < 2 * s.decoder.da.device_bytes \
    + 8 * 4096
sx = ShardedExecutor(s, mesh, cache_blocks=8)
plan = QueryPlanner(s).plan_spans(np.array([0]),
                                  np.array([min(len(data), 32768)]))
sx.run(plan); sx.run(plan)
assert sx.cache_info()["hits"] > 0, "sharded cache reported no hits"
print("sharded smoke OK:", sx.cache_info()["hits"], "hits,",
      part.per_shard_device_bytes, "B/shard")
PYEOF
echo "ci_torch: OK ($DEV)"
