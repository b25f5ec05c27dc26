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
configs).

`--manual-dp` trains data-parallel with an explicit all-reduce of loss
and gradients (`make_manual_dp_step`), int8-compressed with
`--grad-compress`. Alone it runs a world of one; under torchrun each
rank takes its rows of every global batch, on card LOCAL_RANK:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --manual-dp \
        --grad-compress --reduced --archive corpus.acegad

Every rank opens the same archive; rank 0 checkpoints to `--ckpt-dir`,
rank r > 0 to a `rank<r>` directory below it.
"""
import contextlib
import argparse
import os
import sys

from repro_torch.launch import hygiene

# allocator swap + env must precede torch's first large allocation; the
# argparse pass happens later, so the re-exec trigger is a plain argv scan
hygiene.maybe_reexec_tcmalloc("--tcmalloc" in sys.argv)
hygiene.apply_process_hygiene()

import torch  # noqa: E402  (after hygiene, deliberately)
import torch.distributed as dist  # noqa: E402

from repro_torch.api.archive import GenomicArchive  # noqa: E402
from repro_torch.checkpoint.checkpointer import (CheckpointConfig,  # noqa: E402
                                                 Checkpointer)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.decoder import resolve_device  # noqa: E402
from repro_torch.data.fastq import make_fastq  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    run_resilient_training)
from repro_torch.launch.mesh import dp_group, make_local_mesh  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402
from repro_torch.training.train_step import (init_train_state,  # noqa: E402
                                             make_manual_dp_step,
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
                    help="data parallelism with explicit all-reduce (a "
                         "world of one, or torchrun's)")
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 gradient all-reduce (requires --manual-dp)")
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

    unroll = max(1, args.unroll)
    if args.manual_dp and unroll > 1:
        raise SystemExit("--unroll pairs with the per-step train step; "
                         "drop it for --manual-dp")
    device = resolve_device(args.device)
    if (args.manual_dp and device.type == "cuda" and device.index is None
            and "LOCAL_RANK" in os.environ):
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    args.device = device
    with (dp_group(device) if args.manual_dp else contextlib.nullcontext()):
        _train(args, device, unroll)


def _train(args, device: torch.device, unroll: int) -> None:
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
    ckpt_dir = os.path.join(args.ckpt_dir, args.arch)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if rank:
        ckpt_dir = os.path.join(ckpt_dir, f"rank{rank}")
    ck = Checkpointer(CheckpointConfig(directory=ckpt_dir))
    if args.resume and ck.latest_step() is not None:
        restored = ck.restore(device=device)
        manifest = restored.pop("_manifest")
        state = restored
        start = int(manifest["extra"].get("step", 0))
        ds.load_state_dict(manifest["extra"]["loader"])
        print(f"resumed from step {start} (dataset step {ds.step})")

    make_stream = None
    if args.manual_dp:
        mesh = make_local_mesh()
        inner = make_manual_dp_step(model, opt, mesh, remat=args.remat,
                                    compress=args.grad_compress)
        print(f"data-parallel over {mesh.size} rank(s) "
              f"(grad_compress={args.grad_compress})")

        def step(st, batch):
            return inner(st, batch, 1)
    elif unroll > 1:
        step = make_unrolled_train_step(model, opt, remat=args.remat)
        make_stream = lambda: ds.windows(unroll)       # noqa: E731
    else:
        step = make_train_step(model, opt, remat=args.remat)

    run_resilient_training(step, state, None, ck, n_steps=args.steps,
                           start_step=start, ckpt_every=args.ckpt_every,
                           loader=ds, log_every=10,
                           steps_per_batch=unroll, make_stream=make_stream,
                           device=device)
    print("training complete;", ck.latest_step())


if __name__ == "__main__":
    main()
