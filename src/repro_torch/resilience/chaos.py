"""Closed-loop chaos harness for the self-healing decode paths.

    python -m repro_torch.resilience.chaos --smoke [--device cpu]

Builds a small parity-protected archive on `--device` (default the CUDA
card), then drives the fault scenarios through the full detect → recover
→ degrade loop and asserts the hard contract each time: output is either
BIT-PERFECT (recovered, or the flip landed in entropy padding slack) or
a TYPED error/outcome — never silently wrong bytes. Exits nonzero on the
first violated contract. `--seed` reseeds the injector; identical seeds
replay identical faults.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _log(msg: str) -> None:
    print(f"[chaos] {msg}", flush=True)


def _mk(data: bytes, mode: str, entropy: str, device, anchor_interval: int = 0,
        parity_group: int = 4, **kw):
    from repro_torch.core.encoder import encode
    from repro_torch.core.index import ReadIndex
    from repro_torch.core.residency import CompressedResidentStore
    a = encode(data, block_size=256, mode=mode, entropy=entropy,
               anchor_interval=anchor_interval, parity_group=parity_group)
    idx = ReadIndex.fixed_records(len(data) // 128, 128, 256)
    return CompressedResidentStore(a, index=idx, device=device, **kw)


def scenario_flip_repair(data: bytes, seed: int, device) -> None:
    """Single payload-word flip per trial: decode_all + cached
    fetch_reads must both return bit-perfect output, with at least one
    parity reconstruction once a flip is actually detected."""
    from repro_torch.resilience.faults import FaultInjector
    ref = np.frombuffer(data, np.uint8)
    for mode, entropy, ai in (("ra", "rans", 0), ("ra", "raw", 0),
                              ("global", "rans", 8)):
        st = _mk(data, mode, entropy, device, anchor_interval=ai,
                 cache_blocks=8, verify=True, on_error="repair")
        fi = FaultInjector(seed=seed)
        ids = np.arange(st.index.n_reads)
        ref_rows = st.fetch_reads(ids)[0].cpu().numpy()
        for trial in range(20):
            fi.flip_payload_word(st.decoder)
            got = st.decoder.decode_all(verify=True, on_error="repair")
            assert np.array_equal(got, ref), (
                f"{mode}/{entropy}: decode_all NOT bit-perfect")
            rows = st.fetch_reads(ids)[0].cpu().numpy()
            assert np.array_equal(rows, ref_rows), (
                f"{mode}/{entropy}: cached fetch_reads NOT bit-perfect")
            if st.decoder.recover_info()["reconstructed"] >= 1:
                break
        else:
            raise AssertionError(
                f"{mode}/{entropy}: no flip detected in 20 trials")
        _log(f"flip→repair {mode}/{entropy}: "
             f"{st.decoder.recover_info()} (trial {trial + 1})")


def scenario_partial_serving(data: bytes, seed: int, device) -> None:
    """Two corruptions in one parity group: the group is unrecoverable;
    a ServingFrontend cycle must complete every unaffected request and
    resolve the hit ones as typed `ReadCorrupt` — no silent zeros."""
    from repro_torch.api.archive import GenomicArchive
    from repro_torch.core.format import block_payload_bounds
    from repro_torch.resilience.faults import FaultInjector
    from repro_torch.serving.frontend import ReadCorrupt, ServingFrontend
    st = _mk(data, "ra", "rans", device, cache_blocks=8)
    ga = GenomicArchive(st)
    fe = ServingFrontend({"wgs": ga}, verify=True, on_error="partial")
    fe.register_tenant("clinical", "wgs")
    fi = FaultInjector(seed=seed)
    starts, ends = block_payload_bounds(st.decoder.archive)
    k = st.decoder.archive.parity_group
    blks = next([b for b in range(g * k, (g + 1) * k)
                 if ends[b] - starts[b] > 2][:2]
                for g in range(st.decoder.da.n_blocks // k)
                if sum(ends[b] - starts[b] > 2
                       for b in range(g * k, (g + 1) * k)) >= 2)
    ids = np.arange(st.index.n_reads)
    ref_rows = st.fetch_reads(ids)[0].cpu().numpy()
    for trial in range(20):
        for b in blks:
            fi.flip_payload_word(st.decoder, block=b)
        if st._cache is not None:
            st._cache.invalidate(np.asarray(blks, np.int64))
        tickets = [fe.submit("clinical", int(i)) for i in ids]
        fe.drain()
        res = [fe.result(t) for t in tickets]
        corrupt = [r for r in res if r.status == "corrupt"]
        if corrupt:
            break
    else:
        raise AssertionError("double corruption never detected")
    for r, i in zip(res, ids):
        if r.status == "corrupt":
            assert isinstance(r.payload, ReadCorrupt), r.payload
        else:
            assert r.status in ("ok", "late")
            assert np.array_equal(r.payload, ref_rows[i][:len(r.payload)]), (
                f"healthy request {i} disturbed")
    info = st.decoder.recover_info()
    assert info["unrecoverable"] >= 1 and info["quarantined"] >= 1, info
    _log(f"partial serving: {len(corrupt)} corrupt / {len(res)} total, "
         f"{info}, tenant stats "
         f"{fe.stats()['tenants']['clinical']['corrupt']} corrupt")


def scenario_transient(data: bytes, seed: int, device) -> None:
    """Injected transient decode failures: the call raises a typed
    `TransientDecodeError`; an immediate retry of the SAME call succeeds
    bit-perfectly (the hook disarms itself)."""
    from repro_torch.resilience.faults import (FaultInjector,
                                               TransientDecodeError)
    st = _mk(data, "ra", "rans", device)
    fi = FaultInjector(seed=seed)
    ref = np.frombuffer(data, np.uint8)
    fi.transient_failures(st.decoder, n=2)
    failures = 0
    for _ in range(4):
        try:
            got = st.decoder.decode_all(verify=True)
            break
        except TransientDecodeError:
            failures += 1
    assert failures == 2, f"expected 2 transient failures, saw {failures}"
    assert np.array_equal(got, ref), "post-transient decode NOT bit-perfect"
    _log(f"transient: {failures} injected failures, retry clean")


# The reference's prefetch-crash scenario waits for the port's prefetch
# worker (the training data plane slice), its shard-loss scenario for
# mesh-partitioned residency (the multi-GPU slice).
SCENARIOS = (scenario_flip_repair, scenario_partial_serving,
             scenario_transient)


def smoke_data(n_bytes: int) -> bytes:
    """Compressible but non-trivial bytes: repeated motifs + noise."""
    rng = np.random.default_rng(123)
    motif = rng.integers(0, 255, 64, dtype=np.uint8)
    reps = np.tile(motif, n_bytes // 64 + 1)[:n_bytes]
    noise = rng.integers(0, 255, n_bytes, dtype=np.uint8)
    return np.where(rng.random(n_bytes) < 0.2, noise, reps) \
        .astype(np.uint8).tobytes()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--smoke", action="store_true",
                   help="small corpus, every scenario once")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bytes", type=int, default=16 * 1024,
                   help="corpus size (smoke default 16 KiB)")
    p.add_argument("--device", default="cuda",
                   help="device of the archive (default the CUDA card)")
    args = p.parse_args(argv)
    data = smoke_data(args.bytes)
    failed = 0
    for fn in SCENARIOS:
        t0 = time.perf_counter()
        try:
            fn(data, args.seed, args.device)
            _log(f"PASS {fn.__name__} "
                 f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
        except Exception as e:                       # noqa: BLE001
            failed += 1
            _log(f"FAIL {fn.__name__}: {type(e).__name__}: {e}")
    _log(f"{len(SCENARIOS) - failed}/{len(SCENARIOS)} scenarios passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
