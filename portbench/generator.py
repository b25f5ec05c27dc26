"""The one traffic generator: a traffic mix is a data file it reads.

`portbench/traffic/<mix>.json` holds the mix's parameters: its `kind`,
`in_flight` (requests the closed loop keeps outstanding),
`checked_requests` (requests of the window held against the reference)
and the kind's own keys. Each kind is a module of its own,
`portbench/kinds/<kind>.py`, found by that name, which gives:

  check(traffic)              raise if the kind's keys are missing
  requests(traffic, ref, rng) an endless stream of requests
  entry(store)                the store's entry call the requests drive
  size(spec, ref)             (items, raw bytes) a request delivers
  record(spec)                what a request keeps of its spec after the
                              window (metrics read it), or None
  wrong_bytes(ref, spec, out) bytes of a host copy of the entry call's
                              output that differ from the reference's

So a new mix is a data file, and a new kind a module beside the others.
Every seed gives the same sizes in another order.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream); any whole seed."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def load_kind(root: Path, traffic: dict) -> ModuleType:
    """The module of the traffic's kind, `root/portbench/kinds/<kind>.py`,
    after it has checked the traffic's keys."""
    name = str(traffic.get("kind"))
    path = root / "portbench" / "kinds" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"traffic kind {name!r} has no module at "
                                f"{path}")
    spec = importlib.util.spec_from_file_location(
        "portbench_kind_" + "".join(c if c.isalnum() else "_" for c in name),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key in ("in_flight", "checked_requests"):
        if int(traffic.get(key, 0)) < 1:
            raise ValueError(f"traffic needs {key} >= 1")
    mod.check(traffic)
    return mod
