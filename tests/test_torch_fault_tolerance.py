"""The port's fault-tolerant training loop, mirroring
`tests/test_fault_tolerance.py` (watchdog, restart after injected
failures, restart budget, loader replay), the training-backoff test of
`tests/test_resilience.py` and the two `run_resilient_training` tests of
`tests/test_prefetch.py`, then the port's launcher end to end on the CPU
in a subprocess (encode once, train, checkpoint; reopen without
re-encoding and resume)."""
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.api.archive import GenomicArchive
from repro_torch.checkpoint.checkpointer import Checkpointer, CheckpointConfig
from repro_torch.configs import get_config
from repro_torch.data.fastq import make_fastq
from repro_torch.data.pipeline import (CompressedResidentDataLoader,
                                       PipelineConfig)
from repro_torch.distributed.fault_tolerance import (StragglerWatchdog,
                                                     run_resilient_training)
from repro_torch.models.registry import build_model
from repro_torch.resilience.faults import TransientDecodeError
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*a):
    pass


def test_watchdog_flags_stragglers():
    wd = StragglerWatchdog(warmup=3, threshold=2.0)
    for _ in range(5):
        assert not wd.observe(1.0)
    assert wd.observe(5.0)
    assert wd.stragglers == 1
    assert not wd.observe(1.1)


def _setup(tmp_path):
    cfg = get_config("internlm2-1.8b").reduced()
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    state = init_train_state(model, torch.Generator().manual_seed(0), opt)
    dl = CompressedResidentDataLoader(
        make_fastq("platinum", n_reads=300, seed=4),
        PipelineConfig(seq_len=32, batch_size=2, block_size=2048),
        device="cpu")
    step = make_train_step(model, opt, remat="none")
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    return step, state, dl, ck


def test_restart_after_injected_failure(tmp_path):
    step, state, dl, ck = _setup(tmp_path)
    fails = {"n": 0}

    def fail_twice(s):
        if s == 7 and fails["n"] < 2:
            fails["n"] += 1
            raise RuntimeError("injected")

    out = run_resilient_training(step, state, iter(dl), ck, n_steps=12,
                                 ckpt_every=5, fail_hook=fail_twice,
                                 loader=dl, log_every=100, log=_quiet)
    assert fails["n"] == 2
    assert ck.latest_step() == 12
    assert out["params"]["embed"].device.type == "cpu"
    assert int(out["opt"]["step"]) == 12     # restored at step 5, then 7


def test_restart_budget_exceeded(tmp_path):
    step, state, dl, ck = _setup(tmp_path)

    def always_fail(s):
        raise RuntimeError("dead node")

    with pytest.raises(RuntimeError, match="restart budget"):
        run_resilient_training(step, state, iter(dl), ck, n_steps=5,
                               fail_hook=always_fail, max_restarts=2,
                               loader=dl, log=_quiet)


def test_loader_state_replay():
    dl = CompressedResidentDataLoader(
        make_fastq("platinum", n_reads=200, seed=5),
        PipelineConfig(seq_len=32, batch_size=2, block_size=2048, seed=9),
        device="cpu")
    [dl.next_ids() for _ in range(5)]
    st = dl.state_dict()
    later = [dl.next_ids() for _ in range(3)]
    dl.load_state_dict(st)
    replay = [dl.next_ids() for _ in range(3)]
    for a, b in zip(later, replay):
        np.testing.assert_array_equal(a, b)


def test_training_backoff_bounded_exponential_deterministic():
    def delays_for(seed):
        delays = []
        fails = {2, 4, 6}

        def train_step(state, batch):
            return state, {"loss": torch.zeros(1)}

        def fail_hook(step):
            if step in fails:
                fails.discard(step)
                raise TransientDecodeError(f"injected at {step}")

        def batches():
            while True:
                yield {"x": np.zeros(1)}

        with tempfile.TemporaryDirectory() as d:
            run_resilient_training(
                train_step, {"w": np.zeros(1)}, batches(),
                Checkpointer(CheckpointConfig(directory=d)),
                n_steps=8, ckpt_every=1,
                max_restarts=5, fail_hook=fail_hook, log=_quiet,
                backoff_base_s=0.5, backoff_max_s=1.0, backoff_seed=seed,
                sleep=delays.append, device="cpu")
        return delays

    d1 = delays_for(7)
    assert len(d1) == 3
    assert all(x > 0 for x in d1)
    for got, nominal in zip(d1, (0.5, 1.0, 1.0)):
        assert nominal <= got < nominal * 1.1
    assert d1 == delays_for(7)          # deterministic per seed


# ------------------------------------- fault tolerance on the dataset
@pytest.fixture(scope="module")
def archive():
    return GenomicArchive.from_records(make_fastq("platinum", n_reads=600,
                                                  seed=7),
                                       record_bytes=33, block_size=4096,
                                       device="cpu")


def _accum_step(state, batch):
    acc = state["acc"] + batch["tokens"].to(torch.int64).sum()
    return {"acc": acc.to(torch.int32)}, {"loss": acc.to(torch.float32)}


def test_resilient_training_restarts_prefetched_stream(tmp_path, archive):
    """Injected failure mid-run with an active prefetch worker: restore
    through the dataset surface, resume, and land on a bit-identical
    final accumulator vs the clean run."""

    def run(ckdir, fail_hook=None):
        ds = archive.dataset(batch_size=4, seq_len=32, prefetch=2, seed=13)
        ck = Checkpointer(CheckpointConfig(directory=str(ckdir)))
        state = {"acc": torch.zeros((), dtype=torch.int32)}
        out = run_resilient_training(
            _accum_step, state, None, ck, n_steps=10, ckpt_every=4,
            fail_hook=fail_hook, loader=ds, log=_quiet)
        assert not ds.prefetch_stats()["alive"]   # loop closed the worker
        return int(out["acc"])

    clean = run(tmp_path / "clean")
    fails = {"n": 0}

    def fail_once(step):
        if step == 6 and fails["n"] < 1:
            fails["n"] += 1
            raise RuntimeError("injected mid-prefetch")

    recovered = run(tmp_path / "failing", fail_hook=fail_once)
    assert fails["n"] == 1
    assert recovered == clean


def test_resilient_training_unrolled_windows(tmp_path, archive):
    def accum_window(state, window):
        acc = state["acc"] + window["tokens"].to(torch.int64).sum()
        return ({"acc": acc.to(torch.int32)},
                {"loss": torch.full((2,), float(acc))})

    ds = archive.dataset(batch_size=4, seq_len=32, prefetch=2, seed=13)
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    out = run_resilient_training(
        accum_window, {"acc": torch.zeros((), dtype=torch.int32)}, None, ck,
        n_steps=10, ckpt_every=4, loader=ds, steps_per_batch=2,
        make_stream=lambda: ds.windows(2), log=_quiet)
    assert ck.latest_step() == 10
    ds2 = archive.dataset(batch_size=4, seq_len=32, prefetch=0, seed=13)
    total = sum(int(b["tokens"].to(torch.int64).sum())
                for _, b in zip(range(10), ds2))
    ds2.close()
    assert int(out["acc"]) == total


# ------------------------------------------------------------ launcher
def _launch(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)


def test_launcher_trains_checkpoints_and_resumes_on_the_cpu(tmp_path):
    common = ["--device", "cpu", "--reduced", "--batch", "2", "--seq", "32",
              "--reads", "300", "--block", "4096", "--prefetch", "2",
              "--unroll", "2", "--archive", str(tmp_path / "c.acegad"),
              "--ckpt-dir", str(tmp_path / "ck")]
    first = _launch(common + ["--steps", "4"])
    assert first.returncode == 0, first.stderr[-2000:]
    assert "saved archive" in first.stdout
    assert "training complete; 4" in first.stdout
    again = _launch(common + ["--steps", "6", "--resume"])
    assert again.returncode == 0, again.stderr[-2000:]
    assert "no re-encode" in again.stdout
    assert "resumed from step 4 (dataset step 4)" in again.stdout
    assert "training complete; 6" in again.stdout


def test_launcher_refuses_the_cpu_without_a_card_and_later_slices(
        monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train.main(["--reduced", "--steps", "1"])
    # --manual-dp is ported: it refuses the unrolled step as the
    # reference does, and the card's absence
    with pytest.raises(SystemExit, match="--unroll"):
        train.main(["--manual-dp", "--unroll", "2", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train.main(["--manual-dp", "--reduced", "--steps", "1"])
    # --tune-target is ported: it too refuses the card's absence
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train.main(["--tune-target", "seek", "--reduced", "--steps", "1"])
