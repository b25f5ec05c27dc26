"""Quickstart (PyTorch port): one query plane over a compressed,
device-resident FASTQ.

Encode once, hold the archive compressed in device memory, then address it
any way you like — read ids, absolute byte ranges, or `samtools`-style
named regions — through the `GenomicArchive` facade. Queries bigger than a
memory budget stream. Decodes run the port's CUDA kernels on the card
(`--device cuda`, the default) or their plain versions (`--device cpu`).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import json

import numpy as np

from repro_torch.api import ByteRange, GenomicArchive, ReadId
from repro_torch.core.decoder import resolve_device
from repro_torch.data.fastq import make_fastq
from repro_torch.kernels import ops


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reads", type=int, default=3000)
    ap.add_argument("--sample-kib", type=int, default=256,
                    help="the autotuner's corpus sample")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # 1. a synthetic PCR-free-style FASTQ (no network in this container)
    fastq = make_fastq("platinum", n_reads=args.reads, seed=0)
    print(f"FASTQ: {len(fastq):,} bytes")

    # 2. encode + index + name table, all in one facade — the autotuner
    #    sweeps the knob grid on a sample and picks the encode profile
    #    for a declared objective instead of a hand-tuned block size
    ga = GenomicArchive.create(fastq, target="seek",
                               sample_bytes=args.sample_kib * 1024,
                               device=device)
    print(f"tuned profile: {ga.profile.describe()}")
    print(ga)

    # 3. query by READ ID: one batch → one covering-block selection decode
    n = args.reads
    ids = [7 % n, min(1234, n - 1), n - 1]
    rows, lens = ga.query([ReadId(i) for i in ids])
    print(f"3 reads in one decode: lengths {lens.cpu().tolist()}")

    # 4. query by NAME — `samtools faidx` semantics, resolved through the
    #    device-resident name table (1-based inclusive coordinates)
    name = f"SRR0.{ids[1]}"
    read = bytes(ga[name])
    sub = bytes(ga[f"{name}:1-40"])
    assert read.startswith(sub)
    print(f"read {name}: {read.splitlines()[0].decode()} "
          f"(name table: {ga.names.device_bytes:,}B on device)")

    # 5. query by BYTE RANGE — position-invariant: only covering blocks
    #    decode, wherever the range lands
    lo = min(min(17, ga.stats().n_blocks - 1) * ga.block_size + 100,
             ga.raw_size - 256)
    ref = np.frombuffer(fastq, np.uint8)
    assert np.array_equal(ga[lo:lo + 256], ref[lo:lo + 256])
    print(f"byte slice [{lo}:{lo + 256}): bit-perfect, touched "
          f"~1/{ga.stats().n_blocks} blocks")

    # 6. STREAM anything bigger than a memory budget (paper §5 v7-RA):
    #    whole-archive decode under 128 KB of decoded residency
    budget = 128 * 1024
    total = 0
    for i, chunk in enumerate(ga.stream([ByteRange(0, ga.raw_size)],
                                        max_resident_bytes=budget)):
        assert np.array_equal(chunk, ref[total:total + chunk.size])
        total += chunk.size
    assert total == ga.raw_size
    print(f"streamed {total:,} bytes in {i + 1} chunks, never holding "
          f"more than {budget:,}B decoded")

    # 7. whole-file check, bit-perfect
    out = ga.store.decoder.decode_all()
    assert np.array_equal(out, ref)
    print("whole-file decode: bit-perfect")
    print(json.dumps({"example": "quickstart", "device": str(device),
                      "launches": dict(ops.LAUNCHES)}))


if __name__ == "__main__":
    main()
