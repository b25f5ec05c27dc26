"""Fault tolerance of the training loop.

Pieces:
  StragglerWatchdog — per-step wall-time EWMA + deviation flagging.
  run_resilient_training — checkpointed training loop that survives step
      failures: on exception, restore the latest checkpoint and continue
      (restart budget bounded, backoff bounded and seeded). Failure
      injection hook for tests.
  elastic_reshard — restore a checkpoint re-sharded for a new mesh (or
      whole onto one device); the data-pipeline sampler state replays to
      the restored step, so the token stream is exactly resumed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time monitor. observe() → True marks the step a straggler."""
    alpha: float = 0.1
    threshold: float = 2.0          # × EWMA considered straggling
    warmup: int = 5
    _ewma: float = 0.0
    _n: int = 0
    stragglers: int = 0

    def observe(self, step_time_s: float) -> bool:
        self._n += 1
        if self._n <= self.warmup:
            self._ewma = (step_time_s if self._ewma == 0.0
                          else 0.5 * (self._ewma + step_time_s))
            return False
        is_straggler = step_time_s > self.threshold * self._ewma
        if is_straggler:
            self.stragglers += 1
        else:
            self._ewma = (1 - self.alpha) * self._ewma \
                + self.alpha * step_time_s
        return is_straggler


def _host(x) -> np.ndarray:
    """A metric on the host: a device tensor is copied back, which waits
    for the step that computed it."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def _last_loss(metrics: Dict) -> float:
    """Scalar loss for logging — unrolled steps report a (U,) stack; the
    window's last step is the comparable number."""
    return float(_host(metrics["loss"]).reshape(-1)[-1])


def _state_device(state: Dict):
    for v in state.values():
        if isinstance(v, dict):
            d = _state_device(v)
            if d is not None:
                return d
        elif isinstance(v, torch.Tensor):
            return v.device
    return None


def run_resilient_training(
    train_step: Callable,
    state: Dict,
    batches,                       # iterator of batches (None → make_stream)
    ckpt: Checkpointer,
    n_steps: int,
    start_step: int = 0,
    ckpt_every: int = 50,
    max_restarts: int = 3,
    fail_hook: Optional[Callable[[int], None]] = None,
    loader=None,
    log_every: int = 10,
    log: Callable = print,
    steps_per_batch: int = 1,
    make_stream: Optional[Callable[[], object]] = None,
    backoff_base_s: float = 0.0,
    backoff_max_s: float = 30.0,
    backoff_jitter: float = 0.1,
    backoff_seed: int = 0,
    sleep: Callable[[float], None] = time.sleep,
    device=None,
) -> Dict:
    """Checkpoint/restart training loop. `fail_hook(step)` may raise to
    inject failures (tests). On failure: restore the latest checkpoint
    (+ loader state) onto `device` (default the device of the state's
    tensors, else the card), rebuild the batch stream, continue.

    Transient failures get bounded exponential backoff before the
    restart: restart r sleeps `min(backoff_max_s, backoff_base_s *
    2**(r-1)) * (1 + backoff_jitter * u)` with `u ~ U[0,1)` drawn from a
    `backoff_seed`-seeded generator — deterministic across identical
    runs. The default `backoff_base_s=0` keeps restarts immediate;
    `sleep` is injectable.

    The loader is consumed strictly through the `ArchiveDataset` surface:
    `state_dict()/load_state_dict()` for the restore point, `close()` to
    stop a live prefetch worker, and iteration to resume it.
    `steps_per_batch > 1` declares an unrolled step whose batches are
    (U, B, T) windows (pass `make_stream=lambda: loader.windows(U)` so
    rebuilt streams keep the window shape). Each step waits for its loss
    on the host, so a failure surfaces at the step that caused it."""
    if device is None:
        device = _state_device(state) or "cuda"
    watchdog = StragglerWatchdog()
    if make_stream is None:
        if loader is not None:
            make_stream = lambda: iter(loader)         # noqa: E731
        elif batches is not None:
            make_stream = lambda: iter(batches)        # noqa: E731
        else:
            raise ValueError("need batches or loader/make_stream")
    restarts = 0
    backoff_rng = np.random.default_rng(backoff_seed)
    step = start_step
    it = iter(batches) if batches is not None else make_stream()
    if ckpt.latest_step() is None:       # bootstrap restore point
        extra = {"loader": loader.state_dict()} if loader is not None else {}
        extra["step"] = step
        ckpt.save(step, state, extra=extra)
    while step < n_steps:
        try:
            if fail_hook is not None:
                fail_hook(step)
            t0 = time.time()
            batch = next(it)
            state, metrics = train_step(state, batch)
            _host(metrics["loss"])
            dt = time.time() - t0
            if watchdog.observe(dt):
                log(f"[ft] step {step}: straggler ({dt:.3f}s vs "
                    f"EWMA {watchdog._ewma:.3f}s)")
            prev = step
            step += steps_per_batch
            if step // log_every > prev // log_every:
                log(f"step {step}: loss={_last_loss(metrics):.4f} "
                    f"({dt:.2f}s)")
            if step // ckpt_every > prev // ckpt_every or step >= n_steps:
                extra = ({"loader": loader.state_dict()}
                         if loader is not None else {})
                extra["step"] = step
                ckpt.save(step, state, extra=extra)
        except KeyboardInterrupt:
            raise
        except Exception as e:                      # noqa: BLE001
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(
                    f"exceeded restart budget ({max_restarts})") from e
            delay = min(backoff_max_s,
                        backoff_base_s * 2.0 ** (restarts - 1))
            delay *= 1.0 + backoff_jitter * float(backoff_rng.random())
            log(f"[ft] step {step} failed ({type(e).__name__}: {e}); "
                f"restoring latest checkpoint (restart {restarts}, "
                f"backoff {delay:.2f}s)")
            if delay > 0.0:
                sleep(delay)
            restored = ckpt.restore(device=device)
            manifest = restored.pop("_manifest")
            state = restored
            step = int(manifest["extra"].get("step", manifest["step"]))
            if loader is not None and "loader" in manifest["extra"]:
                loader.load_state_dict(manifest["extra"]["loader"])
                it = make_stream()
    if loader is not None and hasattr(loader, "close"):
        loader.close()                   # no prefetch worker outlives us
    return state


def elastic_reshard(ckpt: Checkpointer, shardings: Optional[Dict] = None,
                    step: Optional[int] = None, device="cuda") -> Dict:
    """Restore a checkpoint (default the latest) re-sharded for a new mesh
    — the elastic scale-up/down path. `shardings` is a flat {tensor path:
    (mesh, spec)} for the new mesh: each such path restores as one slice
    a mesh device (`Checkpointer.restore`); paths with no entry restore
    whole on `device`."""
    return ckpt.restore(step=step, device=device, shardings=shardings)
