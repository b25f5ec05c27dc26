"""The PyTorch port's kernels: the plain versions (`repro_torch.kernels.ref`)
against the JAX reference oracles and the Pallas kernels in interpret
mode, byte for byte (integer codec math: exact tolerance throughout), and
the dispatch rules of `repro_torch.kernels.ops`. The CUDA kernels
themselves are tested on a card by tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import decoder as rdec
from repro.core import encoder as renc
from repro.core import entropy as rent
from repro.core import format as rfmt
from repro.core.decoder import (_entropy_decode_host, _u16_from_planes,
                                _u32_from_planes, to_device)
from repro.core.format import N_STREAMS
from repro.kernels import ref as rref
from repro.kernels.lz77_match import lz77_decode_blocks_pallas
from repro.kernels.rans_decode import rans_decode_pallas
from repro_torch.core import decoder as pdec
from repro_torch.core import format as pfmt
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref
from test_torch_cuda import MALFORMED, malformed_planes


def _t(x, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype))   # a writable copy


# ------------------------------------------------------------ rANS inputs
def _rans_case(data: bytes, block: int):
    """One archive's streams as inputs of the JAX oracle and of the port."""
    a = renc.encode(data, block_size=block)
    da = to_device(a)
    t_max = max(da.t_max_lit, da.t_max_cmd)
    flat_n = a.n_syms.reshape(-1)
    flat_k = a.lanes.reshape(-1)
    cls = np.tile(np.arange(N_STREAMS, dtype=np.int32), a.n_blocks)
    jax_args = (da.words, jnp.asarray(a.word_off.reshape(-1).astype(np.int32)),
                jnp.asarray(flat_n), jnp.asarray(flat_k), jnp.asarray(cls))
    port_args = dict(words=_t(a.words.view(np.int16)),
                     word_off=_t(a.word_off.reshape(-1), np.int64),
                     n_syms=_t(flat_n, np.int32), lanes=_t(flat_k, np.int32),
                     class_ids=_t(cls), tables=pref.rans_tables(a.freqs, "cpu"),
                     t_max=t_max)
    return a, jax_args, port_args, t_max


def _valid_symbols(rows: np.ndarray, n: np.ndarray, k: np.ndarray):
    return [rent.gather_stream_bytes(rows[s], int(n[s]), int(k[s]))
            for s in range(rows.shape[0]) if n[s]]


@pytest.mark.parametrize("size,block", [(3000, 1024), (20000, 4096),
                                        (999, 512), (65536, 16384)])
def test_rans_ref_vs_jax_ref_shapes(fastq_platinum, size, block):
    a, jax_args, port_args, t_max = _rans_case(fastq_platinum[:size], block)
    rows_jax, T_jax = rref.rans_decode_ref(*jax_args, a.freqs, t_max=t_max)
    rows, T = pref.rans_decode_ref(**port_args)
    assert rows.dtype == torch.uint8
    assert tuple(rows.shape) == tuple(rows_jax.shape)
    np.testing.assert_array_equal(T.numpy(), np.asarray(T_jax))
    # the JAX oracle leaves table symbols outside the valid ones, the port
    # writes zeros there (as the Pallas kernel does): compare valid symbols
    n, k = a.n_syms.reshape(-1), a.lanes.reshape(-1)
    for g1, g2 in zip(_valid_symbols(np.asarray(rows_jax), n, k),
                      _valid_symbols(rows.numpy(), n, k)):
        np.testing.assert_array_equal(g1, g2)


@pytest.mark.parametrize("group", [1, 4, 8])
def test_rans_ref_vs_pallas_group_sizes(fastq_noisy, group):
    """Full rows, zeros included, equal the Pallas kernel's."""
    a, jax_args, port_args, t_max = _rans_case(fastq_noisy[:8000], 2048)
    freqs_t = tuple(map(tuple, a.freqs.tolist()))
    rows_pal = rans_decode_pallas(*jax_args, freqs_t, t_max=t_max,
                                  group=group, interpret=True)
    rows, _ = pref.rans_decode_ref(**port_args)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(rows_pal))


def test_rans_ref_decodes_every_stream(fastq_noisy):
    """Linearized port rows equal the host numpy oracle's streams."""
    a, _, port_args, _ = _rans_case(fastq_noisy[:6000], 1024)
    rows, _ = pref.rans_decode_ref(**port_args)
    n, k = a.n_syms.reshape(-1), a.lanes.reshape(-1)
    want = rent.rans_decode_batch_np(
        a.words, a.word_off.reshape(-1), n, k,
        np.tile(np.arange(N_STREAMS), a.n_blocks), a.freqs)
    got = [rent.gather_stream_bytes(rows[s].numpy(), int(n[s]), int(k[s]))
           for s in range(n.size)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------- rANS into stream rows
def _port(a, device="cpu"):
    """The port's device archive of a reference archive (serialized bytes
    cross over)."""
    return pdec.to_device(pfmt.deserialize(rfmt.serialize(a)), device)


def _payload(fastq_platinum, fastq_noisy, block):
    """Two 128 KiB blocks past 0xFFFF, a few blocks below it."""
    return (fastq_platinum + fastq_noisy if block > 0xFFFF
            else fastq_noisy[:8_000] if block == 512
            else fastq_platinum[:40_000])


@pytest.mark.parametrize("block", [512, 2048, 16384, 131072])
def test_rans_streams_ref_vs_jax_entropy_decode_sel(fastq_platinum,
                                                    fastq_noisy, block):
    """The new rANS plain version (rows → linear segments) equals the
    reference's `_entropy_decode_sel` segment by segment, for 2 and 4
    (block > 0xFFFF) offset planes; the row pad is zero."""
    a = renc.encode(_payload(fastq_platinum, fastq_noisy, block),
                    block_size=block)
    assert a.offset_bytes == (4 if block > 0xFFFF else 2)
    pda = _port(a)
    sel = np.arange(a.n_blocks)[::-1].copy()
    want = rdec._entropy_decode_sel(to_device(a), jnp.asarray(sel), "ref")
    rows = ops.rans_decode_streams(**pdec._rans_inputs(
        pda, torch.from_numpy(sel)))
    lay = pda.layout
    assert rows.shape == (sel.size, lay.row) and lay.row % 16 == 0
    for name, got in lay.split(rows).items():
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[name]))
    assert not rows[:, sum(lay.widths):].any()


# ------------------------------------------------------------ LZ77 inputs
def _match_case(data: bytes, block_size: int, entropy: str = "rans"):
    """Raw (pre-entropy) command planes, as JAX arrays and torch tensors:
    the JAX oracle's i32 columns, the port's same columns, and the port's
    byte-plane arguments of `ops.lz77_decode_planes`."""
    a = renc.encode(data, block_size=block_size, entropy=entropy)
    streams = _entropy_decode_host(a, np.arange(a.n_blocks))
    max_cmds = int(a.n_cmds.max(initial=1))
    n_cmds = jnp.asarray(a.n_cmds)
    planes = _u16_from_planes if a.offset_bytes == 2 else _u32_from_planes
    jax_args = (_u16_from_planes(streams["commands"], n_cmds, max_cmds),
                _u16_from_planes(streams["lengths"], n_cmds, max_cmds),
                planes(streams["offsets"], n_cmds, max_cmds), n_cmds,
                streams["literals"], jnp.asarray(a.block_len))
    names = ("lit_lens", "match_lens", "offsets", "n_cmds", "literals",
             "block_len")
    port_args = {k: _t(v) for k, v in zip(names, jax_args)}
    plane_args = {k: _t(streams[k]) for k in ("literals", "lengths",
                                              "offsets", "commands")}
    plane_args.update(n_cmds=_t(a.n_cmds), block_len=_t(a.block_len),
                      out_size=block_size, max_cmds=max_cmds,
                      offset_bytes=a.offset_bytes)
    return a, jax_args, port_args, plane_args


def deep_chain_payload(n_bytes: int, seg: int = 512, seed: int = 0):
    """A literal segment copied repeatedly between random delimiters: each
    copy matches the previous one, so chains are several hops deep."""
    rng = np.random.default_rng(seed)
    body = rng.integers(0, 256, seg, dtype=np.uint8)
    parts, total = [body], seg
    while total < n_bytes:
        parts += [rng.integers(0, 256, 16, dtype=np.uint8), body]
        total += 16 + seg
    return np.concatenate(parts)[:n_bytes]


@pytest.mark.parametrize("block_size", [512, 2048, 16384])
def test_lz77_ref_vs_jax_ref_and_pallas(fastq_platinum, block_size):
    """The plane-reading plain version equals the JAX oracle on the i32
    columns and the Pallas kernel, at the recorded and early-exit rounds."""
    data = fastq_platinum[:40_000]
    a, jax_args, port_args, plane_args = _match_case(data, block_size)
    src = np.frombuffer(data, np.uint8)
    pal = np.asarray(lz77_decode_blocks_pallas(
        *jax_args, out_size=block_size, interpret=True,
        n_rounds=a.max_depth))
    for n_rounds in (a.max_depth, None):
        want = np.asarray(rref.lz77_decode_blocks_ref(
            *jax_args, block_size, n_rounds=n_rounds))
        got = ops.lz77_decode_planes(**plane_args, n_rounds=n_rounds).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pal)
        np.testing.assert_array_equal(got.reshape(-1)[:src.size], src)


@pytest.mark.parametrize("block,entropy", [(512, "rans"), (2048, "rans"),
                                           (16384, "rans"), (131072, "rans"),
                                           (2048, "raw")])
def test_lz77_planes_ref_vs_jax_decode_sel_core(fastq_platinum, fastq_noisy,
                                                block, entropy):
    """The new match plain version fed the linear planes of the port's
    entropy stage (rANS rows or raw unpack) equals the reference's
    `_decode_sel_core` at the archive's rounds, at None and one round
    short, and the source bytes at the archive's rounds."""
    data = _payload(fastq_platinum, fastq_noisy, block)
    a = renc.encode(data, block_size=block, entropy=entropy)
    r = rdec.Decoder(a, backend="ref")
    pda = _port(a)
    sel = np.arange(a.n_blocks)
    tsel = torch.from_numpy(sel)
    m = pdec._match_inputs(pda, pdec._entropy_decode_sel(pda, tsel), tsel)
    src = np.frombuffer(data, np.uint8)
    short = max(a.max_depth - 1, 0)
    for n_rounds in (a.max_depth, None, short):
        want = np.asarray(rdec._decode_sel_core(
            r.arrays, jnp.asarray(sel), r._meta(sel.size, n_rounds=n_rounds),
            "ref"))
        got = pref.lz77_decode_planes_ref(**m, n_rounds=n_rounds).numpy()
        np.testing.assert_array_equal(got, want)
        if n_rounds != short:
            np.testing.assert_array_equal(got.reshape(-1)[:src.size], src)


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_lz77_planes_ref_malformed_vs_jax(case):
    """Malformed command planes (a pointer cycle, bytes past the last
    command, more commands than slots) decode as the JAX oracle does."""
    args = malformed_planes(case, torch.device("cpu"))
    cols = {k: jnp.asarray(args[k].numpy()) for k in
            ("commands", "lengths", "offsets", "n_cmds")}
    C = args["max_cmds"]
    offsets = (_u16_from_planes if args["offset_bytes"] == 2
               else _u32_from_planes)
    jax_args = (_u16_from_planes(cols["commands"], cols["n_cmds"], C),
                _u16_from_planes(cols["lengths"], cols["n_cmds"], C),
                offsets(cols["offsets"], cols["n_cmds"], C),
                cols["n_cmds"], jnp.asarray(args["literals"].numpy()),
                jnp.asarray(args["block_len"].numpy()))
    for n_rounds in (None, 0, 3):
        want = np.asarray(rref.lz77_decode_blocks_ref(
            *jax_args, args["out_size"], n_rounds=n_rounds))
        got = pref.lz77_decode_planes_ref(**args, n_rounds=n_rounds)
        np.testing.assert_array_equal(got.numpy(), want)


def test_lz77_ref_paper1_block_offset_bytes_4(fastq_platinum):
    """1 MiB blocks store 4 offset planes; fixed and early-exit rounds."""
    from repro.data.fastq import make_fastq
    data = fastq_platinum + make_fastq("noisy", n_reads=4600, seed=5)
    block = 1024 * 1024
    a, jax_args, port_args, _ = _match_case(data, block)
    assert a.offset_bytes == 4 and a.n_blocks == 2
    src = np.frombuffer(data, np.uint8)
    for n_rounds in (a.max_depth, None):
        want = np.asarray(rref.lz77_decode_blocks_ref(
            *jax_args, block, n_rounds=n_rounds))
        got = pref.lz77_decode_blocks_ref(**port_args, out_size=block,
                                          n_rounds=n_rounds).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got.reshape(-1)[:src.size], src)


def test_lz77_depth_is_tight():
    """max_depth rounds decode bit-perfect; max_depth - 1 rounds do not,
    and the corrupt bytes equal the JAX oracle's."""
    raw = deep_chain_payload(30_000)
    a, jax_args, port_args, _ = _match_case(raw.tobytes(), 4096)
    assert a.max_depth > 1
    for n_rounds, exact in ((a.max_depth, True), (a.max_depth - 1, False)):
        got = pref.lz77_decode_blocks_ref(**port_args, out_size=4096,
                                          n_rounds=n_rounds).numpy()
        want = np.asarray(rref.lz77_decode_blocks_ref(
            *jax_args, 4096, n_rounds=n_rounds))
        np.testing.assert_array_equal(got, want)
        assert np.array_equal(got.reshape(-1)[:raw.size], raw) == exact


def test_expand_pointers_vs_jax(fastq_noisy):
    import jax
    a, jax_args, port_args, _ = _match_case(fastq_noisy[:9000], 1024)
    want = jax.vmap(lambda *r: rref.expand_pointers(*r, 1024))(
        *jax_args[:4], jax_args[5])
    got = pref.expand_pointers(port_args["lit_lens"], port_args["match_lens"],
                               port_args["offsets"], port_args["n_cmds"],
                               port_args["block_len"], 1024)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_early_exit_stops_on_malformed_cycle():
    """A pointer cycle stops at the log2 cap instead of looping forever."""
    ptr = torch.tensor([[1, 2, 0, -1]])
    out = pref.resolve_rounds(ptr.clone(), None)
    want = rref.resolve_rounds(jnp.asarray(np.array([1, 2, 0, -1],
                                                    np.int32)), None)
    np.testing.assert_array_equal(out.numpy()[0], np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lz77_ref_random_payloads(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 4, int(rng.integers(1, 8000)),
                        dtype=np.uint8).tobytes()
    _, _, port_args, _ = _match_case(data, 1024)
    got = pref.lz77_decode_blocks_ref(**port_args, out_size=1024).numpy()
    np.testing.assert_array_equal(got.reshape(-1)[:len(data)],
                                  np.frombuffer(data, np.uint8))


# ------------------------------------------------------------ dispatch
def test_cpu_tensors_take_the_plain_version_uncounted(fastq_noisy):
    a, _, _, plane_args = _match_case(fastq_noisy[:3000], 1024)
    before = dict(ops.LAUNCHES)
    ops.lz77_decode_planes(**plane_args)
    pda = _port(a)
    ops.rans_decode_streams(**pdec._rans_inputs(pda, torch.arange(2)))
    assert ops.LAUNCHES == before


def test_other_devices_raise_instead_of_falling_back():
    meta = torch.empty((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.lz77_decode_planes(meta, meta, meta, meta, meta, meta, 16, 1, 2)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.rans_decode_streams(meta, meta, meta, meta, (),
                                pref.stream_layout(16, 1, 2))


def test_stream_layout_tiles_the_row():
    lay = pref.stream_layout(16384, 569, 2)
    assert lay.widths == (16384, 1138, 1138, 1138)
    assert lay.starts == (0, 16384, 17522, 18660, 19808)
    rows = torch.arange(3 * lay.row).reshape(3, lay.row)
    views = lay.split(rows)
    assert [v.shape[1] for v in views.values()] == list(lay.widths)
    assert views["commands"][1, 0] == rows[1, 18660]
