"""Serving example (PyTorch port): batched requests against a
compressed-resident store.

Request contexts are addressed by READ ID: the paper's read→block index +
position-invariant block decode fetch each context on the device (no host
round trip — the §6.1 argument), then the model decodes new tokens with
its KV cache. Reports per-phase latency.

    PYTHONPATH=src python examples/serve_compressed_resident_torch.py \
        [--device cpu]
"""
import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import encoder
from repro_torch.core.decoder import resolve_device
from repro_torch.core.index import ReadIndex
from repro_torch.core.residency import CompressedResidentStore
from repro_torch.data.fastq import make_fastq
from repro_torch.kernels import ops
from repro_torch.models.registry import build_model
from repro_torch.serving.serve_step import ServeConfig, ServeSession
from repro_torch.tune import autotune


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reads", type=int, default=3000)
    ap.add_argument("--sample-kib", type=int, default=256,
                    help="the autotuner's corpus sample")
    ap.add_argument("--new-tokens", type=int, default=16)
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = get_config("qwen2-1.5b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))

    corpus = make_fastq("platinum", n_reads=args.reads, seed=0)
    # serving wants fast point lookups: tune the encode knobs for seek
    # latency on a corpus sample instead of hand-picking a block size
    profile = autotune(corpus, target="seek",
                       sample_bytes=args.sample_kib * 1024,
                       device=device).profile
    print(f"tuned profile [seek]: {profile.describe()}")
    archive = encoder.encode(corpus, profile=profile)
    idx = ReadIndex.build(corpus, archive.block_size)
    store = CompressedResidentStore(archive, idx, device=device)
    st = store.stats()
    print(f"corpus resident compressed: {st.compressed_device_bytes:,}B of "
          f"{st.raw_size:,}B raw ({st.residency_fraction_of_raw:.1%})")

    sess = ServeSession(model, params,
                        ServeConfig(max_seq=96,
                                    max_new_tokens=args.new_tokens),
                        store=store)

    batch_ids = [i % args.reads for i in (7, 123, 999, 2048)]
    t0 = time.perf_counter()
    rows = store.fetch_records(np.asarray(batch_ids), 64)
    _sync(device)
    t_fetch = time.perf_counter() - t0
    print(f"context fetch (decode-on-demand, batch={len(batch_ids)}): "
          f"{t_fetch * 1e3:.2f} ms")

    t0 = time.perf_counter()
    toks = sess.serve_reads(batch_ids, ctx_bytes=64)
    _sync(device)
    t_gen = time.perf_counter() - t0
    print(f"generated {toks.shape[1]} tokens x {toks.shape[0]} requests in "
          f"{t_gen * 1e3:.1f} ms")
    # fixed 64-byte records at arithmetic offsets: the corpus's bytes
    src = np.frombuffer(corpus, np.uint8)
    for rid, row in zip(batch_ids, rows.cpu().numpy()):
        assert np.array_equal(row, src[rid * 64:(rid + 1) * 64]), rid
    for rid, t in zip(batch_ids, toks):
        read = np.asarray(store.fetch_read(rid))
        print(f"  read {rid}: context={bytes(read[:20])!r}... "
              f"-> tokens {t[:8].tolist()}")
    print(json.dumps({"example": "serve", "device": str(device),
                      "launches": dict(ops.LAUNCHES)}))


if __name__ == "__main__":
    main()
