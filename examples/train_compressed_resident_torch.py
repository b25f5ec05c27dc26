"""End-to-end training example (PyTorch port): LM trained on a
compressed-resident corpus.

Every batch is fetched by random-access decode from the device-resident
archive (the paper's §4 random access driving the input pipeline) through
the `GenomicArchive.dataset(...)` data plane: async prefetch decodes
batch k+1 while step k runs, `--unroll` feeds (U, B, T) windows — one
DecodePlan per window — to the unrolled train step, and checkpoints
capture the dataset's stream position for bit-exact resume.

    PYTHONPATH=src python examples/train_compressed_resident_torch.py \
        --arch qwen2-1.5b --steps 200 --reduced --prefetch 2 --unroll 4 \
        [--device cpu]
"""
import argparse
import json
import tempfile

import torch

from repro_torch.api.archive import GenomicArchive
from repro_torch.checkpoint.checkpointer import (CheckpointConfig,
                                                 Checkpointer)
from repro_torch.configs import get_config
from repro_torch.core.decoder import resolve_device
from repro_torch.data.fastq import make_fastq
from repro_torch.distributed.fault_tolerance import run_resilient_training
from repro_torch.kernels import ops
from repro_torch.models.registry import build_model
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (init_train_state,
                                             make_train_step,
                                             make_unrolled_train_step)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reads", type=int, default=4000)
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--unroll", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    print(f"arch={args.arch} reduced={args.reduced} family={cfg.family}")

    corpus = make_fastq("platinum", n_reads=args.reads, seed=0)
    ga = GenomicArchive.from_records(corpus, record_bytes=args.seq + 1,
                                     block_size=16 * 1024, device=device)
    ds = ga.dataset(batch_size=args.batch, seq_len=args.seq,
                    prefetch=args.prefetch)
    st = ga.stats()
    print(f"corpus {st.raw_size} B raw -> {st.compressed_device_bytes} B "
          f"device-resident "
          f"({st.raw_size / max(1, st.compressed_device_bytes):.2f}x); "
          f"{ds!r}")

    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    state = init_train_state(
        model, torch.Generator(device=device).manual_seed(0), opt)
    unroll = max(1, args.unroll)
    if unroll > 1:
        step = make_unrolled_train_step(model, opt, remat="none")
        make_stream = lambda: ds.windows(unroll)       # noqa: E731
    else:
        step = make_train_step(model, opt)
        make_stream = None

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="aceapex_ckpt_")
    ck = Checkpointer(CheckpointConfig(directory=ckpt_dir))
    state = run_resilient_training(step, state, None, ck,
                                   n_steps=args.steps, ckpt_every=50,
                                   loader=ds, log_every=10,
                                   steps_per_batch=unroll,
                                   make_stream=make_stream, device=device)
    print(f"done; checkpoints in {ckpt_dir} "
          f"(latest step {ck.latest_step()}); "
          f"prefetch {ds.prefetch_stats()}")
    ds.close()
    print(json.dumps({"example": "train", "device": str(device),
                      "launches": dict(ops.LAUNCHES)}))


if __name__ == "__main__":
    main()
