"""The port's benchmark harness: one cell, one seed, one run.

A cell of `BENCHMARK.json` names a configuration (its file of sizes),
a traffic mix (`portbench/traffic/<mix>.json`, a data file of the kind
`portbench/kinds/<kind>.py` it names, see `portbench.generator`) and
metrics, each read by its own reader, `portbench/metrics/<metric>.py`.
The harness finds all of them by name, so a new configuration, mix,
kind, metric or cell is new files and entries.

A run:

1. set-up, counted from the process's start: the tile is generated
   from the seed (`portbench.reference.fastq`) and the program
   (`repro_torch`) encodes it, in a worker process while torch loads
   and the card starts; the program tiles the archive and makes it
   resident as a `CompressedResidentStore`; then a few requests of the
   cell's own shapes warm the kernels and the allocator;
2. the window: a closed loop keeps `in_flight` requests outstanding
   through the store's entry call for `--seconds`, then waits for the
   last; each request's completion is read from a CUDA event on the
   device's clock, anchored to the host's. With `--trace 1` the profiler
   covers the window's last part;
3. the check: a sample of the requests, drawn from the seed, is held
   against the plain NumPy reference (`portbench.reference.records`),
   byte for byte, once the window has closed, the peak memory has been
   read and the program's state has been freed.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

from portbench import generator, roofline
from portbench import trace as tracing
from portbench.reference.fastq import aligned_tile
from portbench.reference.records import Reference

# top-level module names that may not be loaded where a result is printed
BANNED = ("jax", "jaxlib", "flax", "repro")
TRACE_S = 3.0              # the traced part of a --trace 1 window, at most
DRAIN_S = 60.0             # how long past the window's close a request may
                           # take before it counts as never come
WARM_REQUESTS = 8
HOST_SETUP_TIMEOUT_S = 600


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


# ------------------------------------------------------------------ the cell
@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    kind_module: ModuleType         # portbench/kinds/<kind>.py
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell `workload` of `root/BENCHMARK.json`, with its
    configuration, its traffic mix and the metrics it reports."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    kind_module = generator.load_kind(root, traffic)

    def mine(metrics):
        return [m for m in metrics
                if "workloads" not in m or workload in m["workloads"]]

    return Cell(name=workload, config=config, traffic=traffic,
                kind_module=kind_module, chips=int(w["chips"]),
                end_to_end=mine(spec["end_to_end"]),
                per_layer=mine(spec["per_layer"]))


def load_reader(root: Path, name: str) -> Callable:
    """`read(ctx)` of `root/portbench/metrics/<name>.py`."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------------- set-up
@dataclasses.dataclass
class Session:
    """One configuration made resident, with its reference and the
    entry call the cell's traffic drives."""
    cell: Cell
    seed: int
    device: object
    store: object
    reference: Reference
    work: roofline.RangeWork
    call: Callable
    setup_parts: Dict[str, float] = dataclasses.field(default_factory=dict)


def check_config(cfg: dict) -> None:
    raw = cfg["tiles"] * cfg["tile_blocks"] * cfg["block_size"]
    if cfg["raw_bytes"] != raw:
        raise ValueError(f"raw_bytes={cfg['raw_bytes']} is not tiles x "
                         f"tile_blocks x block_size = {raw}")


class Laps:
    """Named seconds of the steps of set-up."""

    def __init__(self):
        self.parts: Dict[str, float] = {}
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name], self.t = now - self.t, now


def host_setup(config: dict, seed: int) -> tuple:
    """The host half of set-up, which needs no card: the tile generated
    from the seed, and the program's encode of it → (tile bytes,
    archive, {step: seconds}). It runs in a worker process (`HostSetup`)
    beside the card's start-up."""
    from repro_torch.core.encoder import encode
    check_config(config)
    bs = int(config["block_size"])
    lap = Laps()
    tile, _ = aligned_tile(config, int(config["tile_blocks"]), bs,
                           generator.rng_for(seed, 0))
    lap("generate")
    a = encode(tile, block_size=bs, **config["encode"])
    lap("encode")
    return tile, a, lap.parts


class HostSetup:
    """`host_setup` in a worker process of its own (`python -m
    portbench.harness <request>`), started at once, which pickles its
    result to its standard output. A plain subprocess: it starts no
    helper process of its own."""

    def __init__(self, root: Path, config: dict, seed: int):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(root), str(root / "src")]
            + [p for p in [env.get("PYTHONPATH")] if p])
        request = json.dumps({"config": config, "seed": seed})
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "portbench.harness", request], env=env,
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE)

    def result(self, timeout: float) -> tuple:
        out, _ = self.proc.communicate(timeout=timeout)
        if self.proc.returncode:
            raise RuntimeError(f"host set-up worker exited with "
                               f"{self.proc.returncode}")
        return pickle.loads(out)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def prepare(cell: Cell, seed: int, host: tuple, device="cuda") -> Session:
    """Make the configuration resident through the program: the host half
    of set-up (`host`, what `HostSetup` returned), then the archive
    tiled and uploaded to `device`. The store has no block cache and no
    verify, as every configuration states, so requests take the fused
    device path."""
    import torch
    from repro_torch.core.residency import CompressedResidentStore
    from repro_torch.data.tiling import tile_archive
    cfg = cell.config
    lap = Laps()
    tile, a, host_parts = host
    lap("host")
    bs = int(cfg["block_size"])
    tiles = int(cfg["tiles"])
    ref = Reference(tile, bs, tiles)
    archive = tile_archive(a, tiles)
    lap("tiling")
    store = CompressedResidentStore(archive, device=device)
    dev = torch.device(device)
    sync(dev)
    lap("store_upload")
    work = roofline.RangeWork(
        roofline.block_work(a.lanes, a.n_syms, a.n_words, a.n_cmds, bs,
                            a.offset_bytes), a.n_blocks)
    return Session(cell=cell, seed=seed, device=dev, store=store,
                   reference=ref, work=work,
                   call=cell.kind_module.entry(store),
                   setup_parts={**{f"host.{k}": v for k, v in
                                   host_parts.items()}, **lap.parts})


def sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def _requests(sess: Session, stream: int):
    """The cell's requests from stream `stream` of the seed: 1 is the
    window's, 2 warm-up's."""
    return sess.cell.kind_module.requests(
        sess.cell.traffic, sess.reference, generator.rng_for(sess.seed,
                                                             stream))


def warm(sess: Session, requests: int = WARM_REQUESTS) -> None:
    """Run the cell's own request shapes, from a stream of the seed the
    window does not use, and wait for them."""
    gen = _requests(sess, 2)
    outs = collections.deque()
    for _ in range(requests):
        outs.append(sess.call(next(gen)))
        if len(outs) >= int(sess.cell.traffic["in_flight"]):
            outs.popleft()
    sync(sess.device)


def warm_profiler(sess: Session) -> None:
    """Start the profiler once in set-up, so that its own first start
    does not fall in the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    gen = _requests(sess, 2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with torch.profiler.record_function("plan_and_call"):
            sess.call(next(gen))
        sync(sess.device)


# ------------------------------------------------------------------ window
@dataclasses.dataclass
class Request:
    k: int
    spec: object              # what the kind keeps of the request
                              # ((b0, b1) of a scan; None for read ids)
    items: int                # blocks of a scan, reads of a read batch
    raw_bytes: int            # bytes a scan delivers (0 for reads)
    t_issue: float            # host clock, before the entry call
    t_return: float           # host clock, after it
    traced: bool
    done: Optional[float] = None   # completion on the device, host clock


class _Done:
    """Completion of the work enqueued so far: a CUDA event on the card,
    the call's return on the CPU."""

    def __init__(self, dev, anchor):
        self.anchor = anchor
        self.t = time.perf_counter()
        self.ev = None
        if dev.type == "cuda":
            import torch
            self.ev = torch.cuda.Event(enable_timing=True)
            self.ev.record()

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self.ev is None:
            return True
        if timeout is None:
            self.ev.synchronize()
            return True
        end = time.perf_counter() + timeout
        while not self.ev.query():
            if time.perf_counter() > end:
                return False
            time.sleep(0.0002)
        return True

    def time(self) -> float:
        if self.ev is None:
            return self.t
        ev0, t0 = self.anchor
        return t0 + ev0.elapsed_time(self.ev) / 1e3


def _anchor(dev):
    """(event, host time) of a CUDA event recorded on an idle device."""
    if dev.type != "cuda":
        return None
    import torch
    sync(dev)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    ev.synchronize()
    return ev, time.perf_counter()


@dataclasses.dataclass
class Window:
    requests: List[Request]
    kept: List[tuple]           # (Request, spec, output) sampled
    missing: int                # requests that never completed
    t0: float
    t1: float
    trace: object = None        # portbench.trace.Trace
    memory_peak_bytes: Optional[int] = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def run_window(sess: Session, seconds: float, trace: bool = False
               ) -> Window:
    """The closed loop: `in_flight` requests outstanding through the entry
    call for `seconds`, then every request waited for."""
    import torch
    traffic = sess.cell.traffic
    depth = int(traffic["in_flight"])
    keep_n = int(traffic["checked_requests"])
    gen = _requests(sess, 1)
    keep_rng = generator.rng_for(sess.seed, 3)
    kind = sess.cell.kind_module
    dev = sess.device
    inflight = collections.deque()
    reqs: List[Request] = []
    kept: List[tuple] = []
    span = lambda name: contextlib.nullcontext()  # noqa: E731
    prof = win_span = None

    def finish(item):
        r, spec, out, done = item
        r.done = done.time()
        n = r.k + 1                    # reservoir sample of all requests
        if len(kept) < keep_n:
            kept.append((r, spec, out))
        else:
            j = int(keep_rng.integers(0, n))
            if j < keep_n:
                kept[j] = (r, spec, out)

    anchor = _anchor(dev)
    t0 = time.perf_counter()
    end = t0 + seconds
    trace_from = end - min(TRACE_S, seconds / 2) if trace else math.inf
    k = 0
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        if prof is None and now >= trace_from:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            win_span = torch.profiler.record_function(tracing.WINDOW)
            win_span.__enter__()
            span = torch.profiler.record_function
        with span("client"):
            spec = next(gen)
        t_issue = time.perf_counter()
        with span("plan_and_call"):
            out = sess.call(spec)
        t_return = time.perf_counter()
        done = _Done(dev, anchor)
        items, raw_bytes = kind.size(spec, sess.reference)
        r = Request(k=k, spec=kind.record(spec), items=items,
                    raw_bytes=raw_bytes, t_issue=t_issue,
                    t_return=t_return, traced=prof is not None)
        reqs.append(r)
        inflight.append((r, spec, out, done))
        k += 1
        if len(inflight) >= depth:
            with span("wait"):
                item = inflight.popleft()
                item[3].wait()
            with span("check"):
                finish(item)
    missing = 0
    while inflight:
        item = inflight.popleft()
        with span("wait"):
            ok = item[3].wait(timeout=max(0.0, end + DRAIN_S
                                          - time.perf_counter()))
        if ok:
            finish(item)
        else:
            missing += 1
    t1 = time.perf_counter()
    win = Window(requests=reqs, kept=kept, missing=missing, t0=t0, t1=t1)
    if dev.type == "cuda":
        win.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    if prof is not None:
        win_span.__exit__(None, None, None)
        prof.stop()
        win.trace = tracing.from_profiler(prof)
    return win


# ------------------------------------------------------------------- check
def _host(out):
    """An entry call's output (a tensor, or a tuple of them) as numpy."""
    if isinstance(out, tuple):
        return tuple(_host(o) for o in out)
    return out.cpu().numpy() if hasattr(out, "cpu") else out


def check(sess: Session, win: Window) -> tuple:
    """Every sampled request held against the reference, byte for byte,
    by the kind's comparison → ({"wrong_bytes": {"value": v, "limit":
    0}}, wrong requests)."""
    wrong_bytes = wrong_requests = 0
    for r, spec, out in win.kept:
        bad = sess.cell.kind_module.wrong_bytes(sess.reference, spec,
                                                _host(out))
        wrong_bytes += bad
        wrong_requests += bool(bad)
    return {"wrong_bytes": {"value": wrong_bytes, "limit": 0}}, \
        wrong_requests


def correct(checks: Dict[str, dict], checked: int, missing: int) -> bool:
    """At least one request checked, none that never came, and every
    number within its limit."""
    return checked > 0 and not missing and all(
        v["value"] <= v["limit"] for v in checks.values())


# ----------------------------------------------------------------- metrics
@dataclasses.dataclass
class Context:
    """What a metric's reader reads. It is read before the store is
    freed, so a reader may also ask the store (`session.store`) for its
    counters."""
    cell: Cell
    setup_s: float
    window: Window
    session: Session

    @property
    def work(self) -> roofline.RangeWork:
        return self.session.work

    @property
    def kind(self) -> str:
        return self.cell.kind

    @property
    def trace(self):
        return self.window.trace

    @property
    def window_s(self) -> float:
        return self.window.seconds

    @property
    def requests(self) -> List[Request]:
        return self.window.requests

    def traced(self) -> List[Request]:
        return [r for r in self.window.requests if r.traced]

    def untraced(self) -> List[Request]:
        return [r for r in self.window.requests if not r.traced]


def read_metrics(root: Path, metrics: List[dict], ctx: Context
                 ) -> Dict[str, dict]:
    """{name: {value, unit}} of each metric whose reader read something;
    a reader that finds nothing to read returns None and its metric is
    left out."""
    out = {}
    for m in metrics:
        v = load_reader(root, m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device_info(dev, chips: int, peak: Optional[int]) -> dict:
    import torch
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": dev.type, "count": chips,
                "memory_peak_bytes": peak or 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": peak,
            "visible_devices": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        info["nvidia_smi"] = smi.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        info["nvidia_smi"] = [f"unavailable: {e}"]
    return info


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def release(sess: Session) -> None:
    """Drop the store and return its device memory."""
    sess.store = sess.call = None
    gc.collect()
    if sess.device.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        host: tuple, device="cuda", t_start: Optional[float] = None,
        cell: Optional[Cell] = None) -> dict:
    """One run of one cell → the result object (not printed). `host` is
    what `HostSetup` returned, `t_start` the process's start on the
    `time.perf_counter` clock."""
    cell = cell or load_cell(root, workload)
    t = time.perf_counter()
    sess = prepare(cell, seed, host, device=device)
    lap = Laps()
    warm(sess)
    if trace:
        warm_profiler(sess)
    lap("warm")
    sess.setup_parts.update(lap.parts)
    if t_start is None:
        t_start = t
    sess.setup_parts["start_to_prepare"] = t - t_start
    win = run_window(sess, seconds, trace=trace)
    setup_s = win.t0 - t_start
    ctx = Context(cell=cell, setup_s=setup_s, window=win, session=sess)
    metrics = read_metrics(root, cell.per_layer if trace else cell.end_to_end,
                           ctx)
    # the sampled outputs go to the host and the program's state is freed
    # before the reference runs
    win.kept[:] = [(r, spec, _host(out)) for r, spec, out in win.kept]
    release(sess)
    checks, wrong_requests = check(sess, win)
    checked = len(win.kept)
    result = {"correct": correct(checks, checked, win.missing),
              "attempted": len(win.requests),
              "failed": wrong_requests + win.missing, "metrics": metrics,
              "device": device_info(sess.device, cell.chips,
                                    win.memory_peak_bytes)}
    if win.trace is not None:
        result["device"]["busy_s"] = win.trace.busy_s
        result["device"]["window_s"] = win.trace.window_s
        result["breakdown"] = win.trace.breakdown()
    result["setup_parts_s"] = sess.setup_parts
    result["checked_requests"] = checked
    result["missing_requests"] = win.missing
    result["checks"] = checks
    win.kept.clear()
    return result


if __name__ == "__main__":
    # the worker of `HostSetup`: a JSON request as its argument, a pickle
    # out; anything else printed goes to standard error
    out, sys.stdout = sys.stdout.buffer, sys.stderr
    req = json.loads(sys.argv[1])
    pickle.dump(host_setup(req["config"], int(req["seed"])), out,
                protocol=pickle.HIGHEST_PROTOCOL)
