"""Async prefetch: decode batch k+1 while step k runs (framework-free).

`AsyncPrefetcher` runs a pure producer `produce(step)` on a background
worker and hands results through a bounded queue — the decode for the
next batch (lowered through the query plane: DecodePlan → BlockCache →
depth-bucketed launches) is issued, and optionally completed, off the
training loop's critical path. The queue bound is the backpressure
mechanism: a fast producer blocks after `depth` undelivered items, so
at most `depth + 1` batches of decoded rows are ever resident beyond
the one the consumer holds.

Determinism is structural, not synchronized: `produce` must be a pure
function of the step counter (the `ArchiveDataset` samplers are), so
the delivered stream is bit-identical to the synchronous loop at ANY
queue depth, and a checkpoint only needs the consumer's next step — the
in-flight items are recomputed on restore, never persisted.

`PrefetchingLoader` is the iterator view `ArchiveDataset` hands to
training loops: in-order delivery, `next_step` for checkpointing, and
`close()` that provably leaves no worker behind.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Optional, Tuple

_POISON = object()          # worker → consumer: producer raised; see .exc


class PrefetchWorkerError(RuntimeError):
    """Producer raised on the worker; the original is chained as cause."""


class AsyncPrefetcher:
    """Background producer of `produce(step)` for step, step+stride, …

    Parameters
    ----------
    produce : step → item. MUST be a pure function of `step` for the
        delivered stream to be queue-depth-invariant.
    start_step : first step to produce.
    depth : queue bound (≥ 1). The producer blocks once `depth` items
        are waiting — bounded decoded-batch residency by construction.
    stride : step increment between successive items (a window iterator
        producing `unroll` training steps per item passes stride=unroll).
    ready : optional callable run on the worker with each produced item
        (e.g. a wait on the CUDA stream the producer decoded on) so
        device work completes off the consumer's critical path, not just
        gets dispatched there.
    """

    def __init__(self, produce: Callable[[int], Any], start_step: int = 0,
                 depth: int = 2, stride: int = 1,
                 ready: Optional[Callable[[Any], Any]] = None,
                 name: str = "prefetch"):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        self._produce = produce
        self._ready = ready
        self.depth = depth
        self.stride = stride
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.exc: Optional[BaseException] = None
        # instrumentation (host ints, single-writer each)
        self.produced = 0            # items fully produced by the worker
        self.consumed = 0            # items delivered to the consumer
        self.max_ahead = 0           # max produced - consumed observed
        self.stalls = 0              # producer waits on a full queue
        self._thread = threading.Thread(
            target=self._run, args=(int(start_step),), name=name,
            daemon=True)
        self._thread.start()

    # ---------------------------------------------------------------- worker
    def _run(self, step: int) -> None:
        try:
            while not self._stop.is_set():
                item = self._produce(step)
                if self._ready is not None:
                    self._ready(item)
                self.produced += 1
                self.max_ahead = max(self.max_ahead,
                                     self.produced - self.consumed)
                if not self._put((step, item)):
                    return
                step += self.stride
        except BaseException as e:                      # noqa: BLE001
            self.exc = e
            self._put(_POISON)

    def _put(self, item) -> bool:
        """Bounded put that stays responsive to stop(); False = stopping."""
        if self._q.full():
            self.stalls += 1
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # -------------------------------------------------------------- consumer
    def get(self, timeout: Optional[float] = None) -> Tuple[int, Any]:
        """Next (step, item) in order. Raises `PrefetchWorkerError` if the
        producer died, `queue.Empty` on timeout."""
        remaining = timeout
        while True:
            try:
                got = self._q.get(timeout=0.05 if remaining is None
                                  else min(0.05, remaining))
            except queue.Empty:
                if self.exc is not None and self._q.empty():
                    raise PrefetchWorkerError(
                        f"prefetch worker died: {self.exc!r}") from self.exc
                if remaining is not None:
                    remaining -= 0.05
                    if remaining <= 0:
                        raise
                continue
            if got is _POISON:
                raise PrefetchWorkerError(
                    f"prefetch worker died: {self.exc!r}") from self.exc
            self.consumed += 1
            return got

    # ------------------------------------------------------------- lifecycle
    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def stop(self, join_timeout: float = 5.0) -> None:
        """Idempotent shutdown: signal, drain (unblocks a producer stuck on
        a full queue), join. No worker survives this call."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=join_timeout)

    def stats(self) -> dict:
        return {"produced": self.produced, "consumed": self.consumed,
                "max_ahead": self.max_ahead, "stalls": self.stalls,
                "depth": self.depth, "alive": self.alive}

    def __enter__(self) -> "AsyncPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class PrefetchingLoader:
    """In-order iterator over `produce(step)` with prefetch.

    The training-loop view of `AsyncPrefetcher`: iterate to consume,
    read `next_step` to checkpoint (the step the NEXT delivered item
    will carry — in-flight prefetched items are deliberately excluded:
    they are recomputed after a restore, which is what makes restarts
    bit-deterministic at any queue depth), `close()` when done. With
    `depth=0` it degrades to the synchronous loop — same stream, no
    worker — which is the identity the tests pin.
    """

    def __init__(self, produce: Callable[[int], Any], start_step: int = 0,
                 depth: int = 2, stride: int = 1,
                 ready: Optional[Callable[[Any], Any]] = None):
        self._produce = produce
        self._stride = int(stride)
        self.next_step = int(start_step)
        self.depth = int(depth)
        self._pf = (AsyncPrefetcher(produce, start_step=start_step,
                                    depth=depth, stride=stride, ready=ready)
                    if depth > 0 else None)
        self._closed = False

    def __iter__(self) -> "PrefetchingLoader":
        return self

    def __next__(self) -> Any:
        if self._closed:
            raise StopIteration
        if self._pf is None:
            item = self._produce(self.next_step)
            self.next_step += self._stride
            return item
        step, item = self._pf.get()
        assert step == self.next_step, \
            f"out-of-order prefetch delivery: {step} != {self.next_step}"
        self.next_step = step + self._stride
        return item

    def close(self) -> None:
        self._closed = True
        if self._pf is not None:
            self._pf.stop()

    def stats(self) -> dict:
        return self._pf.stats() if self._pf is not None else {
            "produced": 0, "consumed": 0, "max_ahead": 0, "stalls": 0,
            "depth": 0, "alive": False}

    @property
    def alive(self) -> bool:
        return self._pf.alive if self._pf is not None else False

    def __enter__(self) -> "PrefetchingLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
