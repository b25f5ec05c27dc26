"""Legacy loader shim — `CompressedResidentDataLoader` over `ArchiveDataset`.

DEPRECATED surface: the training data plane lives on the query plane as
`GenomicArchive.dataset(...)` → `repro_torch.api.dataset.ArchiveDataset`
(sampling, batching, window coalescing, async prefetch, checkpointable
stream position). This class remains as a thin compatibility shim: it
builds the archive on `device`, delegates every batch to the dataset
(ids lower through one `DecodePlan`, riding the `BlockCache` when
enabled), and keeps the old `state_dict()` keys loadable. New code
should call `GenomicArchive.dataset` directly.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Iterator

import numpy as np
import torch

from repro_torch.api.archive import GenomicArchive


@dataclasses.dataclass
class PipelineConfig:
    seq_len: int = 512
    batch_size: int = 8
    block_size: int = 16 * 1024
    entropy: str = "rans"
    seed: int = 0
    cache_blocks: int = 0     # decoded-block cache capacity (0 = off);
                              # hot blocks skip re-decode across batches
    cache_policy: str = "lru"  # "lru" | "freq" | EvictionPolicy instance
    prefetch: int = 0         # async prefetch depth (0 = synchronous —
                              # the legacy behaviour; the new surface
                              # defaults to 2)


class CompressedResidentDataLoader:
    """DEPRECATED shim over `ArchiveDataset` (see module docstring).

    Infinite sampler of (tokens, labels) batches from a compressed-
    resident byte corpus. Deterministic given (seed, step) — samplers are
    pure functions of the step counter, so `state_dict()` restores are
    O(1) and bit-exact at any prefetch depth."""

    _warned = False

    def __init__(self, corpus: bytes, cfg: PipelineConfig, device="cuda"):
        if not CompressedResidentDataLoader._warned:
            CompressedResidentDataLoader._warned = True
            warnings.warn(
                "CompressedResidentDataLoader is a compatibility shim; "
                "use GenomicArchive.dataset(...) (repro_torch.api) instead",
                DeprecationWarning, stacklevel=2)
        self.cfg = cfg
        rec = cfg.seq_len + 1                     # +1 for shifted labels
        self.archive = GenomicArchive.from_records(
            corpus, record_bytes=rec, block_size=cfg.block_size,
            entropy=cfg.entropy, device=device,
            cache_blocks=cfg.cache_blocks, cache_policy=cfg.cache_policy)
        self.dataset = self.archive.dataset(
            batch_size=cfg.batch_size, seq_len=cfg.seq_len,
            sampler="uniform", prefetch=cfg.prefetch, seed=cfg.seed)
        self.store = self.archive.store
        self.n_records = self.archive.n_reads
        self.record_bytes = rec

    @property
    def step(self) -> int:
        return self.dataset.step

    # --------------------------------------------------------------- state
    def state_dict(self) -> dict:
        return self.dataset.state_dict()

    def load_state_dict(self, st: dict) -> None:
        # accepts both the dataset payload and the legacy {"step","seed"}
        self.dataset.load_state_dict(st)
        self.cfg.seed = int(self.dataset.sampler.seed)

    # -------------------------------------------------------------- batches
    def next_ids(self) -> np.ndarray:
        ids = self.dataset.sampler.sample(self.dataset.step)
        self.dataset.step += 1
        return ids

    def fetch(self, ids: np.ndarray) -> dict:
        # one dataset fetch per batch: ids lower to a DecodePlan and decode
        # through the same cache-riding device pipeline as every other
        # entry point
        rows = self.dataset.fetch_ids(np.asarray(ids, np.int64))
        toks = rows.to(torch.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        # delegate: prefetched (cfg.prefetch > 0) or synchronous stream,
        # resuming from the dataset's checkpointable step either way
        return iter(self.dataset)

    def close(self) -> None:
        self.dataset.close()

    def compression_summary(self) -> str:
        st = self.store.stats()
        return (f"corpus {st.raw_size} B raw -> {st.compressed_device_bytes} B "
                f"device-resident ({st.raw_size / max(1, st.compressed_device_bytes):.2f}x), "
                f"{st.n_blocks} blocks of {self.cfg.block_size}")
