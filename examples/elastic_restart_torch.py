"""Elastic restart demo (PyTorch port): train, kill, restore onto a
DIFFERENT device count.

Simulates losing half the fleet MID-PREFETCH: a checkpoint written under
one device count is restored under another (`elastic_reshard` onto a
mesh of half the devices), and the dataset's `state_dict()` — sampler
config + next-consume step, captured through the `ArchiveDataset`
surface while batches were still in flight on the prefetch worker —
replays the token stream bit-identically on the new mesh: in-flight
batches are recomputed from the pure sampler, never persisted. A mesh
device may repeat, so one card (or the CPU) carries a mesh of any size.

    PYTHONPATH=src python examples/elastic_restart_torch.py \
        [--devices 8] [--device cpu]
"""
import argparse
import json
import tempfile

import numpy as np
import torch

from repro_torch.api.archive import GenomicArchive
from repro_torch.checkpoint.checkpointer import (CheckpointConfig,
                                                 Checkpointer)
from repro_torch.configs import get_config
from repro_torch.core.decoder import resolve_device
from repro_torch.data.fastq import make_fastq
from repro_torch.distributed.fault_tolerance import elastic_reshard
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import build_model
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=8,
                    help="the fleet's device count before the failure")
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    device = resolve_device(args.device)
    n = args.devices
    print(f"devices: {n}")
    cfg = get_config("internlm2-1.8b").reduced()
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60)
    state = init_train_state(
        model, torch.Generator(device=device).manual_seed(0), opt)
    ga = GenomicArchive.from_records(
        make_fastq("platinum", n_reads=args.reads, seed=0), record_bytes=65,
        block_size=4096, device=device)
    ds = ga.dataset(batch_size=8, seq_len=64, prefetch=2)
    step = make_train_step(model, opt, remat="none")

    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(CheckpointConfig(directory=d))
        it = iter(ds)
        for i in range(args.steps):
            state, m = step(state, next(it))
        # checkpoint through the dataset surface while the prefetch
        # worker still holds undelivered batches — exactly the state a
        # dying pod would capture
        ck.save(args.steps, state,
                extra={"loader": ds.state_dict(), "step": args.steps})
        print(f"step {args.steps} loss={float(m['loss']):.4f} "
              f"(in-flight {ds.state_dict().get('in_flight', 0)}) — "
              f"'pod failure' now")
        expect = [next(it)["tokens"].cpu().numpy() for _ in range(3)]
        ds.close()

        # --- restart on a smaller mesh: half the devices ---
        half = max(1, n // 2)
        mesh = make_mesh((half,), ("data",), [device] * half)
        shardings = {f"params.{k}": (mesh, ()) for k in state["params"]}
        restored = elastic_reshard(ck, shardings, device=device)
        manifest = restored.pop("_manifest")
        # each mesh device holds its replica of every parameter
        for k, pieces in restored["params"].items():
            assert len(pieces) == half
            for p in pieces:
                assert torch.equal(p.cpu(), state["params"][k].cpu()), k
        restored["params"] = {k: v[0]
                              for k, v in restored["params"].items()}
        # a FRESH dataset (new process, new mesh) restores the stream
        ds2 = ga.dataset(batch_size=8, seq_len=64, prefetch=2)
        ds2.load_state_dict(manifest["extra"]["loader"])
        print(f"restored step {manifest['extra']['step']} onto {half} "
              f"device(s); payload ratio "
              f"{manifest.get('payload_ratio', 1):.2f}x")

        it2 = iter(ds2)
        replay = [next(it2)["tokens"].cpu().numpy() for _ in range(3)]
        for a, b in zip(expect, replay):
            np.testing.assert_array_equal(a, b)
        print("post-restore batch stream bit-identical across the reshard")
        for i in range(5):
            restored, m = step(restored, next(it2))
        ds2.close()
        print(f"resumed; step {args.steps + 5} loss={float(m['loss']):.4f}")
    print(json.dumps({"example": "elastic_restart", "device": str(device),
                      "launches": dict(ops.LAUNCHES)}))


if __name__ == "__main__":
    main()
