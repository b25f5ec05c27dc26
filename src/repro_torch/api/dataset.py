"""`ArchiveDataset` — the training-grade loader surface of the query plane.

    ga = GenomicArchive.from_records(corpus, record_bytes=seq_len + 1)
    ds = ga.dataset(batch_size=8, prefetch=2)
    for batch in ds:                       # {"tokens": (B,T), "labels": (B,T)}
        state, m = step(state, batch)      # batch k+1 decodes while k runs

Sampling, batching, and prefetch all live here, ON the query plane:
every batch's record ids lower through one `DecodePlan` (riding the
`BlockCache` and depth-bucketed launches like every other entry point),
`windows(n)` coalesces n consecutive batches into ONE plan (covering
blocks dedup across batches; pairs with the unrolled train step), and
`prefetch > 0` decodes batch k+1 on a background worker while step k
runs (`repro_torch.data.prefetch`).

On the card the worker decodes on a CUDA stream of its own, so the
decode kernels overlap the training step on the main stream. Its
`ready` hook waits for that stream before a batch is queued, and the
consumer marks every delivered tensor as used on its own stream
(`Tensor.record_stream`): without that, the caching allocator could hand
a batch's memory to the worker's next decode while the training step
still reads it.

Checkpointing: samplers are pure functions of the step counter, so
`state_dict()` is tiny (next-consume step + sampler config) and restores
are bit-deterministic at ANY prefetch depth — in-flight prefetched
batches are recomputed, not persisted. `load_state_dict` also accepts
the legacy `CompressedResidentDataLoader` `{"step", "seed"}` payload, so
old checkpoints restore onto the new surface. Both packages write and
read the same payloads.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.data.prefetch import PrefetchingLoader


# ------------------------------------------------------------------ samplers
class UniformSampler:
    """Uniform-with-replacement record sampler, pure in the step counter.

    `sample(step)` derives a fresh generator from `(seed, step)` — O(1)
    restore to any step (no stream replay), identical ids whether the
    call happens on the training loop, a prefetch worker, or a restarted
    process. This purity is what keeps prefetch restarts bit-exact."""

    kind = "uniform"

    def __init__(self, n_records: int, batch_size: int, seed: int = 0):
        if n_records < 1:
            raise ValueError("sampler needs n_records >= 1")
        self.n_records = int(n_records)
        self.batch_size = int(batch_size)
        self.seed = int(seed)

    def sample(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=(self.seed, int(step))))
        return rng.integers(0, self.n_records, size=self.batch_size,
                            dtype=np.int64)

    def state_dict(self) -> dict:
        return {"kind": self.kind, "seed": self.seed,
                "n_records": self.n_records, "batch_size": self.batch_size}

    def load_state_dict(self, st: dict) -> None:
        self.seed = int(st["seed"])
        self.n_records = int(st.get("n_records", self.n_records))
        self.batch_size = int(st.get("batch_size", self.batch_size))


class SequentialSampler(UniformSampler):
    """Wrap-around in-order sweep — deterministic epochs, same surface."""

    kind = "sequential"

    def sample(self, step: int) -> np.ndarray:
        base = int(step) * self.batch_size
        return ((base + np.arange(self.batch_size, dtype=np.int64))
                % self.n_records)


_SAMPLERS = {"uniform": UniformSampler, "sequential": SequentialSampler}


def make_sampler(spec: Union[str, dict, UniformSampler], n_records: int,
                 batch_size: int, seed: int = 0):
    """"uniform" | "sequential" | a state_dict | a sampler instance."""
    if isinstance(spec, str):
        return _SAMPLERS[spec](n_records, batch_size, seed=seed)
    if isinstance(spec, dict):
        s = _SAMPLERS[spec["kind"]](n_records, batch_size, seed=seed)
        s.load_state_dict(spec)
        return s
    return spec


# ------------------------------------------------------------------- dataset
class ArchiveDataset:
    """Infinite (tokens, labels) batch stream decoded from a compressed-
    resident archive, as int32 tensors on the archive's device. Built by
    `GenomicArchive.dataset(...)`."""

    def __init__(self, archive, batch_size: int = 8,
                 seq_len: Optional[int] = None,
                 sampler: Union[str, dict, UniformSampler] = "uniform",
                 prefetch: int = 2, seed: int = 0,
                 sync_ready: bool = True, verify: Optional[bool] = None,
                 on_error: Optional[str] = None):
        store = archive.store
        if store.index is None:
            raise ValueError("dataset() needs an indexed archive "
                             "(from_records / from_bytes)")
        self.archive = archive
        self.batch_size = int(batch_size)
        if seq_len is None:
            lens = np.diff(store.index.starts.astype(np.int64))
            if lens.size and (lens == lens[0]).all():
                seq_len = int(lens[0]) - 1      # fixed records: use them all
            else:
                raise ValueError("variable-length records: pass seq_len=")
        self.seq_len = int(seq_len)
        if self.seq_len < 1:
            raise ValueError("seq_len must be >= 1")
        self.record_bytes = self.seq_len + 1    # +1 for shifted labels
        self.n_records = store.index.n_reads
        self.sampler = make_sampler(sampler, self.n_records,
                                    self.batch_size, seed=seed)
        self.prefetch = int(prefetch)
        self.sync_ready = bool(sync_ready)
        # detect→recover knobs for every batch decode (None = the store's
        # defaults); "repair" keeps training bit-exact through parity
        # reconstruction instead of crashing the input pipeline
        self.verify = verify
        self.on_error = on_error
        self.step = 0                 # next step to CONSUME (checkpoint key)
        self._active: Optional[PrefetchingLoader] = None

    @property
    def device(self) -> torch.device:
        return torch.device(self.archive.store.device)

    # ------------------------------------------------------------- fetching
    def fetch_ids(self, ids: np.ndarray) -> torch.Tensor:
        """ids → (len(ids), record_bytes) u8 rows, one DecodePlan through
        the cache-riding device executor (zero-padded past short reads,
        cut past long ones)."""
        rows, _ = self.archive.query(np.asarray(ids, np.int64),
                                     verify=self.verify,
                                     on_error=self.on_error)
        rec = self.record_bytes
        if rows.shape[1] > rec:
            rows = rows[:, :rec]
        elif rows.shape[1] < rec:
            pad = torch.zeros((rows.shape[0], rec), dtype=rows.dtype,
                              device=rows.device)
            pad[:, :rows.shape[1]] = rows
            rows = pad
        return rows

    @staticmethod
    def _to_batch(rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        toks = rows.to(torch.int32)
        return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Pure: the batch the training loop sees at `step`."""
        return self._to_batch(self.fetch_ids(self.sampler.sample(step)))

    def window_at(self, step: int, n: int) -> Dict[str, torch.Tensor]:
        """Steps [step, step+n) coalesced into ONE DecodePlan and stacked
        to (n, B, T) — covering blocks dedup across the whole window and
        decode in one depth-bucketed launch set; the shape the unrolled
        train step consumes."""
        ids = np.concatenate([self.sampler.sample(step + i)
                              for i in range(n)])
        rows = self.fetch_ids(ids)
        rows = rows.reshape(n, self.batch_size, self.record_bytes)
        return self._to_batch(rows)

    # ------------------------------------------------------------ iteration
    def _stream(self, produce, stride: int) -> Iterator[Dict]:
        self.close()                      # one live prefetcher per dataset
        side = None
        ready = None
        if self.prefetch > 0 and self.device.type == "cuda":
            # the worker decodes on its own stream; the kernels launch on
            # the current stream, so they follow it
            side = torch.cuda.Stream(device=self.device)
            plain = produce

            def produce(step):
                with torch.cuda.stream(side):
                    return plain(step)

            if self.sync_ready:
                ready = lambda item: side.synchronize()   # noqa: E731
        loader = PrefetchingLoader(produce, start_step=self.step,
                                   depth=self.prefetch, stride=stride,
                                   ready=ready)
        self._active = loader
        try:
            for item in loader:
                self.step = loader.next_step
                if side is not None:
                    main = torch.cuda.current_stream(self.device)
                    if ready is None:
                        main.wait_stream(side)
                    for t in item.values():
                        t.record_stream(main)
                yield item
        finally:
            loader.close()
            if self._active is loader:
                self._active = None

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        """Per-step batches, prefetched when `prefetch > 0`. Iteration
        RESUMES from `self.step` — restarting an iterator after
        `load_state_dict` continues the exact stream."""
        return self._stream(self.batch_at, stride=1)

    def windows(self, n: int) -> Iterator[Dict[str, torch.Tensor]]:
        """(n, B, T) windows advancing n steps each — the async feed for
        the unrolled train loop."""
        if n < 1:
            raise ValueError("window size must be >= 1")
        return self._stream(lambda s: self.window_at(s, n), stride=n)

    # ----------------------------------------------------------- checkpoint
    def state_dict(self) -> dict:
        """Everything a bit-exact resume needs: the next step the consumer
        will see + the sampler's config. `in_flight`/`produced` are
        observability only — prefetched-but-unconsumed batches are
        recomputed on restore (pure samplers), never persisted."""
        st = {"version": 2, "step": int(self.step),
              "seed": int(self.sampler.seed),
              "sampler": self.sampler.state_dict(),
              "prefetch": self.prefetch}
        if self._active is not None:
            s = self._active.stats()
            st["in_flight"] = int(s["produced"] - s["consumed"])
        return st

    def load_state_dict(self, st: dict) -> None:
        """Accepts this surface's payload or the legacy loader's
        `{"step", "seed"}`. Any live prefetcher is stopped and its queue
        discarded — the next iterator re-produces from the restored step."""
        self.close()
        if "sampler" in st:
            self.sampler = make_sampler(dict(st["sampler"]), self.n_records,
                                        self.batch_size)
        else:                                     # legacy loader payload
            self.sampler.seed = int(st["seed"])
        self.step = int(st["step"])

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Stop any live prefetch worker (idempotent, leak-proof)."""
        if self._active is not None:
            self._active.close()
            self._active = None

    def prefetch_stats(self) -> dict:
        return (self._active.stats() if self._active is not None
                else {"produced": 0, "consumed": 0, "max_ahead": 0,
                      "stalls": 0, "depth": self.prefetch, "alive": False})

    def __enter__(self) -> "ArchiveDataset":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def tokens_per_batch(self) -> int:
        return self.batch_size * self.seq_len

    def __repr__(self) -> str:
        return (f"ArchiveDataset(B={self.batch_size}, T={self.seq_len}, "
                f"records={self.n_records}, sampler={self.sampler.kind}, "
                f"prefetch={self.prefetch}, step={self.step})")
