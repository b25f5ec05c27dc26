"""Spans and counters of the request path.

`span(name)` marks one stage of a request. While a `torch.profiler`
records, it is a profiler range named `PREFIX + name` on the profiler's
clock (a function-scope range: a CPU event with no device-side mirror,
so the device trace's busy time holds kernels only), and the stage's
host interval is also kept in `SPAN_LOG` (`time.perf_counter` seconds)
for readers that have no access to the profiler's events. Otherwise it
is one shared no-op context. There is no switch: spans are on while,
and only while, a profiler records. Spans of one request nest inside
its entry span, on one thread.

Stages: `fetch_block_range`, `fetch_reads`, `fetch_records` (the store's
entry calls); `plan` (the planner and a plan's host coordinates);
`execute` (an executor's run); `upload` (a host-to-device copy of a
plan's coordinates); `cover_sync` (the covering set's `torch.unique`);
`entropy`, `match`, `gather` (the decode and the ragged gather);
`verify` (a block digest).

`COUNTS` holds counters that are always on, in the idiom of
`kernels.ops.LAUNCHES`:

- `requests`: entry calls of the store;
- `route.fused_spans`, `route.fused_ids`, `route.staged`: one per
  `DeviceExecutor.run`, by the route it took;
- `blocks.covered`: unique covering blocks of each executor run;
- `blocks.decoded`: rows a decode materialized (the whole prefix of an
  anchor-free global archive, pow2 padding included);
- `host_syncs`: calls on the request path at which the host waits for
  the card (a pageable upload, the covering set's size, a digest read
  back), counted on every device.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import Deque, Dict, Tuple

import torch

PREFIX = "repro_torch."
COUNTS: Dict[str, int] = dict.fromkeys(
    ("requests", "route.fused_spans", "route.fused_ids", "route.staged",
     "blocks.covered", "blocks.decoded", "host_syncs"), 0)
# (name, start, end) of the spans closed while a profiler recorded
SPAN_LOG: Deque[Tuple[str, float, float]] = collections.deque(
    maxlen=1 << 16)
_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name
        self.rf = torch._C._profiler._RecordFunctionFast(PREFIX + name)

    def __enter__(self):
        self.rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.rf.__exit__(*exc)
        SPAN_LOG.append((self.name, self.t0, t1))


def span(name: str):
    """A context marking stage `name` while a profiler records."""
    if _profiling():
        return _Span(name)
    return _OFF


def spanned(name: str):
    """Decorator: the whole call is one `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(key: str, n: int = 1) -> None:
    COUNTS[key] += n


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
