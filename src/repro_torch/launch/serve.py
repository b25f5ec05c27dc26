"""Serving launcher: batched requests over a compressed-resident corpus.

Requests address the unified query plane: read ids queue in a
`ReadBatcher` (duplicate ids dedup to one batch row) and coalesce into ONE
batched `fetch_reads` selection decode; named `samtools`-style regions
resolve through the device-resident name table (`GenomicArchive.query`);
then generation runs on the fetched contexts.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --requests 16 --new-tokens 16 [--device cuda]

`--device` defaults to the CUDA card and the launcher refuses to start
without one; `--device cpu` runs the plain PyTorch versions of the
kernels.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.archive import GenomicArchive
from repro_torch.configs import get_config
from repro_torch.core.decoder import resolve_device
from repro_torch.data.fastq import make_fastq
from repro_torch.models.registry import build_model
from repro_torch.serving.frontend import ServingFrontend
from repro_torch.serving.serve_step import (ReadBatcher, ServeConfig,
                                            ServeSession)
from repro_torch.serving.traffic import (TenantLoad, ZipfianSampler,
                                         format_report, run_closed_loop)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--ctx-bytes", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-blocks", type=int, default=64,
                    help="decoded-block cache capacity (0 disables)")
    ap.add_argument("--cache-policy", default="tinylfu",
                    choices=("lru", "freq", "tinylfu"),
                    help="block cache eviction/admission policy")
    ap.add_argument("--tenants", type=int, default=2,
                    help="tenants registered on the serving frontend")
    ap.add_argument("--deadline-us", type=float, default=2_000_000.0,
                    help="per-request deadline the frontend holds "
                         "requests to (closed-loop demo)")
    ap.add_argument("--tune-target", default="seek",
                    choices=("seek", "ratio", "throughput"),
                    help="autotuner objective for the encode profile "
                         "(serving is seek-bound, so 'seek' by default)")
    ap.add_argument("--tune-sample-kb", type=int, default=256,
                    help="corpus sample the tuner sweeps, in KiB")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced model config (--no-reduced = full size)")
    ap.add_argument("--device", default="cuda",
                    help="device of the archive and the model (default "
                         "the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))

    corpus = make_fastq("platinum", n_reads=3000, seed=0)
    # encode knobs come from the autotuner's declared objective, not a
    # hand-tuned constant: sweep the grid on a corpus sample, take the
    # Pareto point for the serving-relevant target
    ga = GenomicArchive.create(corpus, target=args.tune_target,
                               sample_bytes=args.tune_sample_kb << 10,
                               device=device,
                               cache_blocks=args.cache_blocks,
                               cache_policy=args.cache_policy)
    print(f"tuned profile [{args.tune_target}]: {ga.profile.describe()}")
    st = ga.stats()
    print(f"resident: {st.compressed_device_bytes:,}B compressed of "
          f"{st.raw_size:,}B ({st.residency_fraction_of_raw:.1%}), "
          f"{ga.names.n_names} named reads")

    # ---- batch endpoint: queued requests → one coalesced, deduped fetch ----
    batcher = ReadBatcher(ga, max_batch=max(args.requests, 256))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, ga.n_reads, size=args.requests)
    tickets = [batcher.submit(r) for r in ids]
    t0 = time.perf_counter()
    reads = batcher.flush()
    t_fetch = time.perf_counter() - t0
    print(f"{len(tickets)} queued requests coalesced into "
          f"{batcher.flushes} fetch(es) of {batcher.unique_fetched} unique "
          f"rows: {t_fetch*1e3:.1f} ms "
          f"({len(tickets)/t_fetch:.0f} reads/s) "
          f"last_flush={batcher.stats()['last_flush_us']:.0f}us "
          f"cache={batcher.cache_info()} counts={dict(obs.COUNTS)}")
    if not all(len(reads[t]) > 0 for t in tickets):
        raise SystemExit("a queued request came back empty")

    # ---- multi-tenant frontend: deadlines, priorities, backpressure ----
    fe = ServingFrontend({"corpus": ga}, max_batch=max(args.requests, 64))
    loads = []
    for i in range(args.tenants):
        name = f"tenant{i}"
        fe.register_tenant(name, "corpus", priority=min(i, 1))
        loads.append(TenantLoad(
            name, ZipfianSampler(ga.n_reads, seed=i), requests=32,
            concurrency=4, deadline_us=args.deadline_us, priority=None))
    report = run_closed_loop(fe, loads, verify_sample=4)
    print(f"frontend closed loop ({args.tenants} tenants, deadline "
          f"{args.deadline_us:.0f}us):")
    print(format_report(report))

    # ---- named region through the device-resident name table ----
    region = f"SRR0.{int(ids[0])}:1-40"
    t0 = time.perf_counter()
    payload = ga[region]
    print(f"region {region!r}: {bytes(payload[:20])!r}... "
          f"({(time.perf_counter()-t0)*1e3:.1f} ms, name table "
          f"{ga.names.device_bytes:,}B device-resident)")

    sess = ServeSession(model, params,
                        ServeConfig(max_seq=args.ctx_bytes + args.new_tokens,
                                    max_new_tokens=args.new_tokens),
                        store=ga)
    t0 = time.perf_counter()
    toks = sess.serve_reads(ids.tolist(), ctx_bytes=args.ctx_bytes)
    dt = time.perf_counter() - t0
    total_new = toks.shape[0] * toks.shape[1]
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    print(f"{args.requests} requests × {args.new_tokens} tokens in "
          f"{dt*1e3:.1f} ms ({total_new/dt:.1f} tok/s on {where})")


if __name__ == "__main__":
    main()
