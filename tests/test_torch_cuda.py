"""The PyTorch port's CUDA kernels on an NVIDIA card, against their plain
PyTorch versions, byte for byte. These tests need a card and nvcc (a
CUDA kernel has no CPU mode) and skip without one; they import no JAX,
so they run on a machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import decoder as dec
from repro_torch.core.encoder import encode
from repro_torch.data.fastq import make_fastq
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("block", [512, 2048, 16384])
def test_kernels_equal_plain_versions(cuda_device, block):
    data = make_fastq("noisy", n_reads=300, seed=block)
    a = encode(data, block_size=block)
    da = dec.to_device(a, cuda_device)
    sel = torch.arange(a.n_blocks, device=cuda_device)
    rin = dec._rans_inputs(da, sel)
    launches = ops.LAUNCHES["rans_decode"]
    rows, _ = ops.rans_decode(**rin)
    assert ops.LAUNCHES["rans_decode"] == launches + 1
    assert torch.equal(rows, ref.rans_decode_ref(**rin)[0])
    m = dec._match_inputs(da, dec._entropy_decode_sel(da, sel), sel)
    for n_rounds in (a.max_depth, None, max(a.max_depth - 1, 0)):
        got = ops.lz77_decode_blocks(**m, n_rounds=n_rounds)
        assert torch.equal(got, ref.lz77_decode_blocks_ref(
            **m, n_rounds=n_rounds))
    src = np.frombuffer(data, np.uint8)
    flat = ops.lz77_decode_blocks(**m, n_rounds=a.max_depth).cpu().numpy()
    np.testing.assert_array_equal(flat.reshape(-1)[:src.size], src)


def test_decoder_and_store_on_the_card(cuda_device):
    from repro_torch.core.index import ReadIndex
    from repro_torch.core.residency import CompressedResidentStore
    data = make_fastq("platinum", n_reads=400, seed=9)
    idx = ReadIndex.build(data, 2048)
    s = CompressedResidentStore(encode(data, block_size=2048), idx,
                                device=cuda_device)
    assert s.decoder.decode_all(chunk_blocks=4, verify=True).tobytes() == data
    ids = np.array([0, 17, 399, 17])
    out, lens = s.fetch_reads(ids)
    assert out.is_cuda
    for i, r in enumerate(ids):
        lo, hi, _ = idx.lookup(int(r))
        assert bytes(out[i, :int(lens[i])].cpu().numpy()) == data[lo:hi]
