"""Training launcher — compressed bytes on disk → train loop on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 100 --reduced --batch 8 --seq 128 \
        --archive corpus.acegad --prefetch 2 --unroll 4 [--device cuda]

The data plane is the query plane: the corpus archive opens (or encodes
ONCE, then `--archive` persists it — later invocations start from the
compressed bytes on disk, no re-encode) into a `GenomicArchive` on
`--device`, and `ga.dataset(...)` drives training — async prefetch
decodes batch k+1 through DecodePlan/BlockCache on its own CUDA stream
while step k runs, `--unroll U` feeds (U, B, T) windows (ONE DecodePlan
per window) to the unrolled train step. Checkpoints are compressed with
the same codec and restore by decoding on the device (`--resume`).
Process hygiene (tcmalloc LD_PRELOAD re-exec, env defaults) applies
before torch loads.

`--device` defaults to the CUDA card and the launcher refuses to start
without one; `--device cpu` runs the plain PyTorch versions (reduced
configs). `--manual-dp` and `--grad-compress` come with a later slice of
the port and exit with a message naming it.
"""
import argparse
import os
import sys

from repro_torch.launch import hygiene

# allocator swap + env must precede torch's first large allocation; the
# argparse pass happens later, so the re-exec trigger is a plain argv scan
hygiene.maybe_reexec_tcmalloc("--tcmalloc" in sys.argv)
hygiene.apply_process_hygiene()

import torch  # noqa: E402  (after hygiene, deliberately)

from repro_torch.api.archive import GenomicArchive  # noqa: E402
from repro_torch.checkpoint.checkpointer import (CheckpointConfig,  # noqa: E402
                                                 Checkpointer)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.decoder import _not_in_slice, resolve_device  # noqa: E402
from repro_torch.data.fastq import make_fastq  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    run_resilient_training)
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402
from repro_torch.training.train_step import (init_train_state,  # noqa: E402
                                             make_train_step,
                                             make_unrolled_train_step)


def build_archive(args) -> GenomicArchive:
    """`--archive PATH` existing → open it (compressed bytes on disk →
    device; zero encode work). Otherwise encode the corpus once —
    through the autotuner when `--tune-target` is set, else with the
    declared block size — and, when `--archive` names a path, save the
    result there so the NEXT invocation opens instead of encoding."""
    rec = args.seq + 1
    if args.archive and os.path.exists(args.archive):
        ga = GenomicArchive.open(args.archive, device=args.device,
                                 cache_blocks=args.cache_blocks)
        got = ga.store.index.starts[1] - ga.store.index.starts[0] \
            if ga.store.index is not None else 0
        if int(got) != rec:
            raise SystemExit(
                f"--archive {args.archive} holds {int(got)}-byte records "
                f"but --seq {args.seq} needs {rec}; re-encode or fix --seq")
        print(f"opened archive {args.archive} ({ga.stats().n_blocks} "
              f"blocks, no re-encode)")
        return ga
    corpus = make_fastq("platinum", n_reads=args.reads, seed=0)
    if args.tune_target:
        ga = GenomicArchive.create(corpus, target=args.tune_target,
                                   record_bytes=rec, device=args.device,
                                   cache_blocks=args.cache_blocks)
        print(f"autotuned profile: {ga.profile.describe()}")
    else:
        ga = GenomicArchive.from_records(corpus, record_bytes=rec,
                                         block_size=args.block,
                                         device=args.device,
                                         cache_blocks=args.cache_blocks)
    if args.archive:
        n = ga.save(args.archive)
        print(f"saved archive -> {args.archive} ({n} B)")
    return ga


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--remat", default="none",
                    choices=["none", "full", "dots"])
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--manual-dp", action="store_true",
                    help="data parallelism with explicit all-reduce "
                         "(multi-GPU slice)")
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 gradient all-reduce (multi-GPU slice)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the archive, the model and the "
                         "checkpoint restore (default the CUDA card)")
    # ------------------------------------------------------- data plane
    ap.add_argument("--archive", default=None, metavar="PATH",
                    help="pre-built archive (GenomicArchive.save). "
                         "Exists: open it, skip encoding. Missing: encode "
                         "once, save here for next time.")
    ap.add_argument("--tune-target", default=None,
                    choices=["seek", "ratio", "throughput"],
                    help="autotune the encode profile "
                         "(repro_torch.tune) instead of hardcoding --block")
    ap.add_argument("--block", type=int, default=16 * 1024)
    ap.add_argument("--reads", type=int, default=4000,
                    help="synthetic corpus size when encoding")
    ap.add_argument("--cache-blocks", type=int, default=0)
    ap.add_argument("--prefetch", type=int, default=2,
                    help="async prefetch queue depth (0 = synchronous)")
    ap.add_argument("--unroll", type=int, default=1,
                    help="steps per dispatch of the unrolled step; the "
                         "window decodes through ONE DecodePlan")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tcmalloc", action="store_true",
                    help="re-exec with tcmalloc LD_PRELOADed")
    args = ap.parse_args(argv)

    if args.manual_dp or args.grad_compress:
        raise SystemExit(str(_not_in_slice(
            "--manual-dp/--grad-compress (data-parallel collectives)",
            "multi-GPU")))
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                      total_steps=args.steps)

    ga = build_archive(args)
    ds = ga.dataset(batch_size=args.batch, seq_len=args.seq,
                    prefetch=args.prefetch, seed=args.seed)
    st = ga.stats()
    print(f"corpus {st.raw_size} B raw -> {st.compressed_device_bytes} B "
          f"device-resident ({st.raw_size / max(1, st.compressed_device_bytes):.2f}x); {ds!r}")

    state = init_train_state(
        model, torch.Generator(device=device).manual_seed(0), opt)
    start = 0
    ck = Checkpointer(CheckpointConfig(
        directory=os.path.join(args.ckpt_dir, args.arch)))
    if args.resume and ck.latest_step() is not None:
        restored = ck.restore(device=device)
        manifest = restored.pop("_manifest")
        state = restored
        start = int(manifest["extra"].get("step", 0))
        ds.load_state_dict(manifest["extra"]["loader"])
        print(f"resumed from step {start} (dataset step {ds.step})")

    unroll = max(1, args.unroll)
    if unroll > 1:
        step = make_unrolled_train_step(model, opt, remat=args.remat)
        make_stream = lambda: ds.windows(unroll)       # noqa: E731
    else:
        step = make_train_step(model, opt, remat=args.remat)
        make_stream = None

    run_resilient_training(step, state, None, ck, n_steps=args.steps,
                           start_step=start, ckpt_every=args.ckpt_every,
                           loader=ds, log_every=10,
                           steps_per_batch=unroll, make_stream=make_stream,
                           device=device)
    print("training complete;", ck.latest_step())


if __name__ == "__main__":
    main()
