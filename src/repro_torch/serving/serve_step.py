"""The batch read endpoint in front of a compressed-resident store.

`ReadBatcher`: requests queue as they arrive and one `flush()` coalesces
them into a single `fetch_reads` selection decode — N queued random
reads cost one kernel pipeline on the device, not N host round-trips.
Duplicate read ids anywhere in the queue are deduplicated: N tickets for
the same read cost one batch row, not N. It routes through the query
plane (`fetch_reads` lowers through QueryPlanner → DeviceExecutor).

The reference's model-serving session pairs this endpoint with a model;
it comes with the model slices of the port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

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
