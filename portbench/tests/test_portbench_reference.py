"""The benchmark's frozen generator makes whole FASTQ records, and the
reference answers the block ranges of a tiled archive (CPU, small
tiles)."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.reference.fastq import aligned_tile, make_fastq  # noqa: E402
from portbench.reference.records import Reference  # noqa: E402

BS = 16384
CONFIG = json.loads((ROOT / "portbench" / "configs" / "err194147-ra16k.json")
                    .read_text())


def record_starts(data: bytes) -> np.ndarray:
    """Starts of the four-line records of `data`, its length last."""
    lines = data.split(b"\n")
    assert lines[-1] == b"" and (len(lines) - 1) % 4 == 0
    lens = np.array([len(x) + 1 for x in lines[:-1]], np.int64)
    ends = np.cumsum(lens)[3::4]
    for k in range(0, len(lines) - 1, 4):
        assert lines[k][:1] == b"@" and lines[k + 2] == b"+"
        assert len(lines[k + 1]) == len(lines[k + 3])
    return np.concatenate([[0], ends])


@pytest.mark.parametrize("n_reads", [1, 300])
def test_generated_records_are_whole_fastq_records(n_reads):
    data, starts = make_fastq(CONFIG, n_reads, np.random.default_rng(3))
    assert np.array_equal(record_starts(data), starts)
    first = data[:starts[1]].split(b"\n")
    assert first[0] == b"@ERR194147.1 1/1" and first[2] == b"+"
    assert len(first[1]) == len(first[3]) == CONFIG["read_len"] == 101
    seq = np.frombuffer(b"".join(data.split(b"\n")[1::4]), np.uint8)
    qual = b"".join(data.split(b"\n")[3::4])
    assert set(seq.tobytes()) <= set(b"ACGT")
    assert set(qual) <= set(CONFIG["qualities"].encode())
    if n_reads > 1:                   # every base and quality drawn
        assert set(seq.tobytes()) == set(b"ACGT")
        assert set(qual) == set(CONFIG["qualities"].encode())


@pytest.mark.parametrize("n_blocks", [1, 3])
def test_aligned_tile_is_whole_records_to_the_block_edge(n_blocks):
    tile, starts = aligned_tile(CONFIG, n_blocks, BS,
                                np.random.default_rng(9))
    assert len(tile) == n_blocks * BS and tile.endswith(b"\n")
    assert np.array_equal(record_starts(tile), starts)


def test_same_seed_same_tile_other_seed_other_tile():
    a = aligned_tile(CONFIG, 2, BS, np.random.default_rng(5))[0]
    b = aligned_tile(CONFIG, 2, BS, np.random.default_rng(5))[0]
    c = aligned_tile(CONFIG, 2, BS, np.random.default_rng(6))[0]
    assert a == b and a != c


@pytest.mark.parametrize("b0,b1", [(0, 3), (1, 6), (5, 12), (11, 12)])
def test_reference_answers_wrap_the_tiles(b0, b1):
    tile, _ = aligned_tile(CONFIG, 3, BS, np.random.default_rng(1))
    ref = Reference(tile, BS, tiles=4)
    assert ref.n_blocks == 12
    whole = np.frombuffer(tile * 4, np.uint8)
    assert np.array_equal(ref.block_rows(b0, b1).reshape(-1),
                          whole[b0 * BS:b1 * BS])


def test_a_tile_that_is_not_block_aligned_is_refused():
    with pytest.raises(ValueError):
        Reference(b"@" * (BS + 1), BS, tiles=2)
