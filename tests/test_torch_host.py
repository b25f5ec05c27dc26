"""The PyTorch port's own copies of the numpy host modules (format,
encoder, entropy, depth, index, fastq) against the JAX package's, byte
for byte; the archive tiling the chip smoke uses; and the port's package
rules: it imports neither jax nor the JAX package, and its entry points
refuse to run on the CPU unless asked to."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import depth as rdepth
from repro.core import encoder as renc
from repro.core import entropy as rent
from repro.core import format as rfmt
from repro.core import index as rindex
from repro.data.fastq import make_fastq as r_make_fastq
from repro_torch.core import depth as pdepth
from repro_torch.core import encoder as penc
from repro_torch.core import entropy as pent
from repro_torch.core import format as pfmt
from repro_torch.core import index as pindex
from repro_torch.data import tiling
from repro_torch.data.fastq import make_fastq as p_make_fastq

PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.mark.parametrize("kind,seed", [("platinum", 1), ("noisy", 2)])
@pytest.mark.parametrize("block,entropy", [(512, "rans"), (2048, "raw"),
                                           (16384, "rans"),
                                           (1024 * 1024, "rans")])
def test_encode_serialize_byte_identical(kind, seed, block, entropy):
    data = r_make_fastq(kind, n_reads=150, seed=seed)
    assert p_make_fastq(kind, n_reads=150, seed=seed) == data
    want = rfmt.serialize(renc.encode(data, block_size=block,
                                      entropy=entropy))
    got = pfmt.serialize(penc.encode(data, block_size=block,
                                     entropy=entropy))
    assert got == want


def test_deserialize_roundtrip_and_corruption(fastq_noisy):
    buf = rfmt.serialize(renc.encode(fastq_noisy[:20_000], block_size=2048))
    a = pfmt.deserialize(buf)
    assert pfmt.serialize(a) == buf and a.offset_bytes == 2
    assert a.max_depth == rfmt.deserialize(buf).max_depth
    with pytest.raises(pfmt.CorruptArchiveError, match="truncated"):
        pfmt.deserialize(buf[:len(buf) // 2])
    with pytest.raises(pfmt.CorruptArchiveError, match="magic"):
        pfmt.deserialize(b"NOTMAGIC" + buf[8:])
    # the parity tail (ACEJAX05) encodes and round-trips byte for byte
    pbuf = rfmt.serialize(renc.encode(fastq_noisy[:3000], block_size=2048,
                                      parity_group=2))
    got = pfmt.serialize(penc.encode(fastq_noisy[:3000], block_size=2048,
                                     parity_group=2))
    assert got == pbuf and pfmt.serialize(pfmt.deserialize(pbuf)) == pbuf


def test_entropy_matches_reference():
    rng = np.random.default_rng(5)
    hist = rng.integers(0, 50, 256) * (rng.random(256) < 0.4)
    np.testing.assert_array_equal(pent.normalize_freqs(hist),
                                  rent.normalize_freqs(hist))
    streams = [rng.integers(0, 16, int(n), dtype=np.uint8)
               for n in rng.integers(0, 3000, 12)]
    cls = rng.integers(0, 4, 12)
    freqs = np.stack([rent.normalize_freqs(np.bincount(
        np.concatenate(streams + [np.arange(16, dtype=np.uint8)]),
        minlength=256)) for _ in range(4)])
    want = rent.rans_encode_batch(streams, cls, freqs)
    got = pent.rans_encode_batch(streams, cls, freqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    dec = pent.rans_decode_batch_np(got[0], got[1], got[3], got[4], cls,
                                    freqs)
    for d, s in zip(dec, streams):
        np.testing.assert_array_equal(d, s)


def test_depth_schedule_matches_reference():
    rng = np.random.default_rng(9)
    d = rng.integers(0, 40, 300)
    np.testing.assert_array_equal(pdepth.scheduled_rounds(d),
                                  rdepth.scheduled_rounds(d))
    np.testing.assert_array_equal(pdepth.depth_bucket(d),
                                  rdepth.depth_bucket(d))
    assert [pdepth.log2_rounds(n) for n in (1, 512, 16384, 1 << 20)] == \
        [rdepth.log2_rounds(n) for n in (1, 512, 16384, 1 << 20)]


def test_index_matches_reference(fastq_noisy):
    pi, ri = (pindex.ReadIndex.build(fastq_noisy, 4096),
              rindex.ReadIndex.build(fastq_noisy, 4096))
    np.testing.assert_array_equal(pi.starts, ri.starts)
    assert pindex.parse_fastq_records(fastq_noisy)[1] == \
        rindex.parse_fastq_records(fastq_noisy)[1]
    with pytest.raises(ValueError, match="malformed"):
        pindex.parse_fastq_records(b"@a\nAC\n-\nII\n")
    # start tables past 2 GiB and 4 GiB split losslessly into i32 pairs
    starts = np.array([0, 2**31 - 1, 2**31 + 5, 2**32 + 17, 9 * 2**30],
                      np.uint64)
    for bs in (16384, 1 << 20):
        blk, rem = pindex.split_starts(starts, bs)
        rb, rr = rindex.split_starts(starts, bs)
        np.testing.assert_array_equal(blk, rb)
        np.testing.assert_array_equal(rem, rr)
        assert blk.dtype == rem.dtype == np.int32
        np.testing.assert_array_equal(
            blk.astype(np.int64) * bs + rem, starts.astype(np.int64))


@pytest.mark.parametrize("parity", [0, 3])
@pytest.mark.parametrize("tiles", [1, 4])
def test_tiled_archive_equals_encoding_the_tiled_corpus(tiles, parity):
    corpus = tiling.aligned_fastq(6, 512, kind="noisy", seed=4)
    assert len(corpus) == 6 * 512
    a = penc.encode(corpus, block_size=512, parity_group=parity)
    assert pfmt.serialize(tiling.tile_archive(a, tiles)) == \
        pfmt.serialize(penc.encode(corpus * tiles, block_size=512,
                                   parity_group=parity))
    # the smoke's parity store: the tail added to a parity-free archive
    # equals encoding with it
    from repro_torch.resilience.parity import with_parity
    if parity:
        assert pfmt.serialize(with_parity(penc.encode(
            corpus, block_size=512), parity)) == pfmt.serialize(a)
        with pytest.raises(ValueError, match="divide"):
            tiling.tile_archive(penc.encode(corpus, block_size=512,
                                            parity_group=4), 2)
    idx = pindex.ReadIndex.build(corpus, 512)
    np.testing.assert_array_equal(
        tiling.tile_index(idx, tiles, len(corpus)).starts,
        pindex.ReadIndex.build(corpus * tiles, 512).starts)
    with pytest.raises(ValueError, match="power of two"):
        tiling.tile_archive(a, 3)


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (n.name for n in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_port_sources_import_neither_jax_nor_the_jax_package():
    sources = sorted(PORT.rglob("*.py")) + [PORT.parents[1] / "chip_smoke.py"]
    scanned = {p.parent.name for p in sources}
    assert {"api", "checkpoint", "configs", "core", "data", "distributed",
            "kernels", "launch", "models", "resilience", "serving",
            "training", "tune"} <= scanned, scanned
    for path in sources:
        for m in _imported_modules(path):
            assert m.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path}: imports {m}"


def test_import_and_fetch_leave_jax_unloaded():
    code = (
        "import sys, numpy as np\n"
        "import repro_torch\n"
        "from repro_torch.core.encoder import encode\n"
        "from repro_torch.core.index import ReadIndex\n"
        "from repro_torch.core.residency import CompressedResidentStore\n"
        "from repro_torch.data.fastq import make_fastq\n"
        "data = make_fastq('noisy', n_reads=60, seed=3)\n"
        "idx = ReadIndex.build(data, 2048)\n"
        "s = CompressedResidentStore(encode(data, block_size=2048), idx,\n"
        "                            device='cpu')\n"
        "out, lens = s.fetch_reads(np.array([0, 7, 59]))\n"
        "lo, hi, _ = idx.lookup(7)\n"
        "assert bytes(out[1, :int(lens[1])].numpy()) == data[lo:hi]\n"
        "import repro_torch.resilience.chaos, repro_torch.serving.traffic\n"
        "from repro_torch.serving import ServingFrontend, ReadBatcher\n"
        "from repro_torch.resilience import FaultInjector\n"
        "FaultInjector(1).flip_payload_word(s.decoder, block=0)\n"
        "s.fetch_reads([0], verify=True, on_error='partial')\n"
        "import repro_torch.launch.train\n"
        "from repro_torch.api.archive import GenomicArchive\n"
        "ga = GenomicArchive.from_records(data, 64, block_size=2048,\n"
        "                                 device='cpu')\n"
        "b = next(iter(ga.dataset(batch_size=2, prefetch=1)))\n"
        "assert b['tokens'].shape == (2, 63)\n"
        "import repro_torch.launch.serve\n"
        "from repro_torch.tune import EncodeProfile, autotune\n"
        "from repro_torch.serving import ServeConfig, ServeSession\n"
        "r = autotune(data, grid=[EncodeProfile(block_size=2048)\n"
        "             .encode_kwargs()], iters=1, device='cpu')\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models.registry import build_model\n"
        "import torch\n"
        "m = build_model(get_config('qwen2-1.5b').reduced())\n"
        "p = m.init(torch.Generator().manual_seed(0))\n"
        "sess = ServeSession(m, p, ServeConfig(max_seq=16), store=ga)\n"
        "assert sess.serve_reads([1, 2], 8, 2).shape == (2, 2)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


def test_entry_points_refuse_the_cpu_without_a_card(monkeypatch,
                                                    tmp_path):
    from repro_torch.api.archive import GenomicArchive
    from repro_torch.core.decoder import Decoder
    from repro_torch.core.residency import CompressedResidentStore
    data = p_make_fastq("noisy", n_reads=20, seed=2)
    a = penc.encode(data, block_size=2048)
    path = str(tmp_path / "a.acegad")
    GenomicArchive.from_bytes(data, block_size=2048, device="cpu").save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.api.address import NameTable
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.tune import EncodeProfile, autotune
    for build in (lambda: Decoder(a),
                  lambda: NameTable.build([b"r0", b"r1"]),
                  lambda: CompressedResidentStore(a),
                  lambda: CompressedResidentStore(a, cache_blocks=4),
                  lambda: GenomicArchive.from_bytes(data, block_size=2048),
                  lambda: GenomicArchive.open(path),
                  lambda: GenomicArchive.create(data, profile=EncodeProfile(
                      block_size=2048)),
                  lambda: autotune(data, iters=1),
                  lambda: build_model(get_config("qwen2-1.5b").reduced())
                  .init_cache(1, 4)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            build()
