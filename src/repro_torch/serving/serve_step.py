"""Batched serving: the batch read endpoint, and prefill → decode with
a KV cache over a compressed-resident store.

`ServeSession` pairs a model with a compressed-resident store: request
contexts are fetched by read id and decoded on the device (paper
§4/§6.1 — the consumer is device-resident, so nothing crosses the host
link), then the decode loop emits tokens step by step, on the device
until one copy to the host at the end.

`ReadBatcher`: requests queue as they arrive and one `flush()` coalesces
them into a single `fetch_reads` selection decode — N queued random
reads cost one kernel pipeline on the device, not N host round-trips.
Duplicate read ids anywhere in the queue are deduplicated: N tickets for
the same read cost one batch row, not N.

Both endpoints route through the query plane (`fetch_reads` lowers
through QueryPlanner → DeviceExecutor), and `ServeSession` accepts any
address the `GenomicArchive` facade resolves (read ids, named regions)
for its request contexts.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.archive import GenomicArchive


@dataclasses.dataclass
class _Pending:
    ticket: int
    read_id: int


class ReadBatcher:
    """Coalesces queued read requests into batched `fetch_reads` calls.

    submit(read_id) → ticket; flush() resolves every pending ticket with
    the read's exact bytes, issuing one selection decode per `max_batch`
    UNIQUE reads (one total when the deduped queue fits the batch).
    Tickets map onto unique batch rows: duplicate ids anywhere in a flush
    decode once, regardless of how the queue slices into batches.

    With the store's decoded-block cache enabled (`cache_blocks > 0`),
    each flush rides the cached DecodePlan path: the covering set splits
    into resident hits and ONE pow2-padded miss decode, and the hot
    Zipfian head stays device-resident across flushes (`cache_info()`
    shows the counters).
    """

    def __init__(self, store, max_batch: int = 256,
                 verify: Optional[bool] = None,
                 on_error: Optional[str] = None):
        # a GenomicArchive is accepted uniformly: fetches and cache
        # counters both resolve against its underlying store
        self.archive: Optional[GenomicArchive] = \
            store if isinstance(store, GenomicArchive) else None
        self.store = self.archive.store if self.archive is not None \
            else store
        self.max_batch = int(max_batch)
        # detect→recover knobs threaded into every flush (None = store
        # defaults). Under on_error="partial", tickets whose read touched
        # an unrecoverable block land in `last_corrupt_tickets` instead of
        # silently carrying zeroed bytes.
        self.verify = verify
        self.on_error = on_error
        self.last_corrupt_tickets: set = set()
        self.corrupt_served = 0
        self._queue: List[_Pending] = []
        self._next_ticket = 0
        self.flushes = 0
        self.served = 0
        self.unique_fetched = 0
        self.last_flush_us = 0.0       # wall time of the latest flush()
        self.total_flush_us = 0.0      # — the serving frontend's service-
                                       # time estimator consumes these

    def submit(self, read_id: int) -> int:
        read_id = int(read_id)
        n = self.store.index.n_reads
        if not 0 <= read_id < n:       # reject at the door: a bad id must
            raise IndexError(          # not poison a whole flushed batch
                f"read id {read_id} out of range [0, {n})")
        t = self._next_ticket
        self._next_ticket += 1
        self._queue.append(_Pending(t, read_id))
        return t

    def pending(self) -> int:
        return len(self._queue)

    def cache_info(self) -> dict:
        """The store's decoded-block cache counters (zeros when off)."""
        return self.store.cache_info()

    def stats(self) -> dict:
        """Serving counters + per-flush latency instrumentation.
        `last_flush_us` is the wall time of the most recent `flush()`
        (every fetch in it, end to end, device work included);
        `avg_flush_us` amortizes over all flushes so far. The multi-tenant
        frontend's service-time estimator reads these to price deadline
        feasibility."""
        return {"flushes": self.flushes, "served": self.served,
                "unique_fetched": self.unique_fetched,
                "corrupt_served": self.corrupt_served,
                "pending": len(self._queue),
                "last_flush_us": self.last_flush_us,
                "avg_flush_us": (self.total_flush_us / self.flushes
                                 if self.flushes else 0.0)}

    def flush(self, mode2: bool = True) -> Dict[int, np.ndarray]:
        """→ {ticket: read bytes (u8, exact length)} for all queued
        requests."""
        out: Dict[int, np.ndarray] = {}
        t0 = time.perf_counter()
        flushed = False
        self.last_corrupt_tickets = set()
        while self._queue:
            # dedup across the WHOLE queue, then decode up to max_batch
            # unique rows per fetch — duplicates never cost a second row
            # even when they land in different slices
            uniq = np.unique(np.asarray([p.read_id for p in self._queue],
                                        np.int64))[:self.max_batch]
            rows, lens = self.store.fetch_reads(uniq, mode2=mode2,
                                                verify=self.verify,
                                                on_error=self.on_error)
            # the copies to the host wait for the device, so the flush's
            # wall time below includes the decode's device work
            rows, lens = rows.cpu().numpy(), lens.cpu().numpy()
            lc = np.asarray(self.store.last_corrupt)
            if lc.size != uniq.size:
                lc = np.zeros(uniq.size, bool)
            pos = {int(r): j for j, r in enumerate(uniq)}
            # dequeue only after the fetch succeeds: a failure leaves
            # every pending ticket intact for a retry flush
            remaining = []
            for p in self._queue:
                j = pos.get(p.read_id)
                if j is None:
                    remaining.append(p)
                    continue
                out[p.ticket] = rows[j, :int(lens[j])]
                if bool(lc[j]):
                    self.last_corrupt_tickets.add(p.ticket)
                    self.corrupt_served += 1
                self.served += 1
            self._queue = remaining
            self.flushes += 1
            self.unique_fetched += int(uniq.size)
            flushed = True
        if flushed:
            self.last_flush_us = (time.perf_counter() - t0) * 1e6
            self.total_flush_us += self.last_flush_us
        return out


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 512
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 = greedy


class ServeSession:
    """A model, its parameters and (optionally) a store to serve from.
    The model runs on the device its parameters live on; contexts
    fetched from a store on another device are moved there."""

    def __init__(self, model, params, cfg: ServeConfig, store=None):
        self.model = model
        self.params = params
        self.cfg = cfg
        if isinstance(store, GenomicArchive):
            self.archive: Optional[GenomicArchive] = store
            self.store = store.store
        elif store is not None:
            self.archive = GenomicArchive(store)
            self.store = store
        else:
            self.archive = self.store = None
        self.device = next(iter(params.values())).device
        self._decode = model.decode_step

    @torch.no_grad()
    def prime(self, contexts: torch.Tensor) -> Dict:
        """Sequential prefill via decode steps (teacher-forced context feed).
        contexts (B, S_ctx) int32."""
        B, S_ctx = contexts.shape
        cache = self.model.init_cache(B, self.cfg.max_seq,
                                      device=self.device)
        logits = None
        for t in range(S_ctx):
            logits, cache = self._decode(self.params, cache,
                                         contexts[:, t:t + 1])
        return {"cache": cache, "logits": logits}

    @torch.no_grad()
    def generate(self, contexts: torch.Tensor,
                 max_new_tokens: Optional[int] = None) -> np.ndarray:
        """Greedy decode of `max_new_tokens` (default the config's) after
        the contexts → (B, n) int32 host array. The tokens stay on the
        device until the one copy at the end."""
        n_new = max_new_tokens or self.cfg.max_new_tokens
        st = self.prime(contexts)
        cache, logits = st["cache"], st["logits"]
        cur = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        toks = [cur]
        for _ in range(n_new - 1):
            logits, cache = self._decode(self.params, cache, cur)
            cur = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            toks.append(cur)
        return torch.cat(toks, dim=1).cpu().numpy()

    def serve_reads(self, read_ids, ctx_bytes: int,
                    max_new_tokens: Optional[int] = None) -> np.ndarray:
        """Batched requests addressed through the query plane:
        compressed-resident fetch → on-device byte contexts → generate.

        With a ReadIndex attached, requests may be read ids OR any address
        the facade resolves (named regions, `"name:start-end"` strings);
        the batch lowers to one `GenomicArchive.query` (truncated /
        zero-padded to `ctx_bytes`). Without an index, ids address fixed
        `ctx_bytes` records.
        """
        if self.store is None:
            raise ValueError("no compressed-resident store attached")
        if self.store.index is not None:
            addrs = (read_ids if isinstance(read_ids, np.ndarray)
                     else list(read_ids))
            rows, _ = self.archive.query(addrs)
            if rows.shape[1] >= ctx_bytes:
                rows = rows[:, :ctx_bytes]
            else:
                rows = torch.nn.functional.pad(
                    rows, (0, ctx_bytes - rows.shape[1]))
        else:
            rows = self.store.fetch_records(np.asarray(read_ids, np.int64),
                                            ctx_bytes)
        contexts = rows.to(self.device, torch.int32)
        return self.generate(contexts, max_new_tokens)
