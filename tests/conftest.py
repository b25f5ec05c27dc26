import os
import sys

# Tests see ONE device (assignment: do not set the 512-device flag globally).
# Multi-device behaviour is tested via subprocesses (tests/test_sharded.py).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running sweeps/property tests — skipped by the CI "
        "fast lane (scripts/ci.sh --fast runs -m 'not slow'), always run "
        "by the full lane")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (the PyTorch port's CUDA "
        "kernels); skipped without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def fastq_platinum():
    from repro.data.fastq import make_fastq
    return make_fastq("platinum", n_reads=400, seed=1)


@pytest.fixture(scope="session")
def fastq_noisy():
    from repro.data.fastq import make_fastq
    return make_fastq("noisy", n_reads=400, seed=2)
