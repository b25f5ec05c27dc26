"""ACEAPEX archive format — absolute-offset LZ77 with self-contained blocks.

Layout (all sizes 64-bit; the 4 GB uint32 overflow fix of paper §5 is a
format-level invariant here):

  Archive
    ├── meta: block_size, mode ("ra" self-contained | "global" wavefront),
    │         raw_size, n_blocks, entropy backend, FNV-1a-64 digests
    ├── entropy tables: 4 stream classes × 256 freqs (normalized to 1<<12)
    ├── words: one flat uint16 buffer holding every rANS-coded stream
    │          (each stream region starts with its K initial lane states
    │           as 2·K little-endian uint16 words)
    └── per-(block, stream) table
          word_off  int64   offset into `words`
          n_words   int32   data words (excludes the 2·K state words)
          n_syms    int32   decoded byte count
          lanes     int32   K — rANS interleave factor for this stream

Four streams per block (paper §2): LITERALS, LENGTHS (match-length byte
planes), OFFSETS (absolute-offset byte planes), COMMANDS (literal-run-length
byte planes).  Command j ≡ (lit_len[j], match_len[j], offset[j]); the
command sequence is the strict alternation literal-run → match with zero
lengths permitted, so COMMANDS carries the lit-run lengths.

Checkpointed wavefronts (v2 header): "global" archives may carry an
*anchor table* — every `anchor_interval` blocks the encoder restarts the
match window, so every match in blocks [anchor, next_anchor) references
only bytes at or after `block_start[anchor]`. Any block range
[first, last] then decodes from the nearest anchor at or before `first`
instead of the whole prefix — Kerbiriou & Chikhi-style periodic restart
points fused with the absolute-offset wavefront. v1 (`ACEJAX02`)
archives deserialize unchanged with an empty anchor table.

Depth-bounded match resolution (v3 header): the encoder measures the
exact pointer-doubling round count each block needs (a host-side fixpoint
over the same expand/resolve recurrence the decoder runs) and records it
per block (`block_depth`, i32). The chain depth is a property of the
*parse*, known at encode time and typically a small constant, so the
decoder runs exactly `max_depth` resolve rounds instead of
⌈log2(block_size)⌉ dense gather rounds — the match phase drops from 20
rounds at the paper-1 1 MiB block size to the archive's true depth.
v1/v2 (`ACEJAX02`/`ACEJAX03`) archives deserialize with depth unknown
(`block_depth is None`) and decode through an early-exit resolver.

Parity-protected archives (v4 header): `encode(..., parity_group=k)` XORs
the compressed payload words of every k-block group into one parity row
(RAID-5 over the word buffer, group-local). A block that fails its
on-device FNV check is reconstructed from its group siblings + parity in
one XOR-gather, re-verified, and the decode retried — single-block
corruption heals without touching the host copy of the data. The parity
tail (`ACEJAX05`) stores the group size, the flat parity words, and the
per-group offsets; parity-free archives keep writing the v3 (`ACEJAX04`)
bytes unchanged, and v1–v3 archives deserialize with `parity_group == 0`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# ---------------------------------------------------------------- constants
DEFAULT_BLOCK_SIZE = 16 * 1024       # paper §2.1: 16 KB seek optimum
PAPER1_BLOCK_SIZE = 1024 * 1024      # paper-1 bulk-throughput tuning

MIN_MATCH = 4                        # below this a match is not worth a cmd
MAX_LEN = 0xFFFF                     # u16 length planes; longer runs split

PROB_BITS = 12                       # rANS probability resolution
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 16                     # state lower bound (16-bit renorm)
MAX_LANES = 32                       # K_max — lane-interleave ceiling

# stream ids
S_LITERALS = 0
S_LENGTHS = 1
S_OFFSETS = 2
S_COMMANDS = 3
N_STREAMS = 4
STREAM_NAMES = ("literals", "lengths", "offsets", "commands")

FNV_OFFSET = np.uint64(0xCBF29CE484222325)
FNV_PRIME = np.uint64(0x100000001B3)


class CorruptArchiveError(ValueError):
    """A serialized archive failed structural validation (bad magic,
    truncated buffer, malformed table) — raised with the name of the
    field that failed, before any decode touches the bytes."""


def fnv1a64(data: np.ndarray) -> int:
    """Reference FNV-1a-64 over bytes (host path; sequential by definition)."""
    h = int(FNV_OFFSET)
    prime = int(FNV_PRIME)
    mask = (1 << 64) - 1
    for b in memoryview(np.ascontiguousarray(data, dtype=np.uint8)).tobytes():
        h = ((h ^ b) * prime) & mask
    return h


def fnv1a64_u64_stride(data: np.ndarray) -> int:
    """FNV-1a-64 over the byte buffer folded to u64 words (8-byte stride).

    This is the device-path digest (paper uses FNV for GPU paths): the same
    recurrence applied per 8-byte word, which vectorizes as a scan on-device.
    Input is zero-padded to a multiple of 8 bytes.
    """
    b = np.ascontiguousarray(data, dtype=np.uint8)
    pad = (-b.size) % 8
    if pad:
        b = np.concatenate([b, np.zeros(pad, np.uint8)])
    words = b.view(np.uint64)
    h = int(FNV_OFFSET)
    prime = int(FNV_PRIME)
    mask = (1 << 64) - 1
    for w in words.tolist():
        h = ((h ^ int(w)) * prime) & mask
    return h


def file_digest(block_fnv: np.ndarray) -> int:
    """Archive-level digest: the FNV-1a-64 recurrence folded over the
    per-block digests (what `Archive.file_fnv` stores)."""
    h = int(FNV_OFFSET)
    prime = int(FNV_PRIME)
    mask = (1 << 64) - 1
    for d in np.asarray(block_fnv, np.uint64).tolist():
        h = ((h ^ int(d)) * prime) & mask
    return h


def lanes_for(n_syms: int, k_max: int = MAX_LANES) -> int:
    """Adaptive interleave factor: small streams get few lanes so the K
    initial states (4·K bytes) do not dominate the compressed size."""
    if n_syms <= 0:
        return 1
    k = 1
    while k * 2 <= k_max and n_syms >= 16 * k * 2:
        k *= 2
    return k


# ---------------------------------------------------------------- containers
@dataclasses.dataclass
class BlockStreams:
    """Raw (pre-entropy) streams of one block."""
    literals: np.ndarray     # u8[n_lit]
    lit_lens: np.ndarray     # u32[n_cmds]
    match_lens: np.ndarray   # u32[n_cmds]
    offsets: np.ndarray      # u64[n_cmds]  absolute output positions

    @property
    def n_cmds(self) -> int:
        return int(self.lit_lens.shape[0])


@dataclasses.dataclass
class Archive:
    """A compressed archive. Everything is flat numpy so it ships to device
    as-is (one tensor per field) for the device-resident pipeline."""
    block_size: int
    raw_size: int                 # int (u64 semantics)
    mode: str                     # "ra" | "global"
    entropy: str                  # "rans" | "raw"
    freqs: np.ndarray             # u16[N_STREAMS, 256] normalized to PROB_SCALE
    words: np.ndarray             # u16[total_words]
    word_off: np.ndarray          # i64[n_blocks, N_STREAMS]
    n_words: np.ndarray           # i32[n_blocks, N_STREAMS]
    n_syms: np.ndarray            # i32[n_blocks, N_STREAMS]
    lanes: np.ndarray             # i32[n_blocks, N_STREAMS]
    n_cmds: np.ndarray            # i32[n_blocks]
    block_start: np.ndarray       # i64[n_blocks]  absolute output start
    block_len: np.ndarray         # i32[n_blocks]
    block_fnv: np.ndarray         # u64[n_blocks] digest of decoded block (8B-stride)
    file_fnv: int                 # digest over block digests
    offset_bytes: int = 2         # bytes per offset plane count ("ra"=2, "global"=8)
    anchor_interval: int = 0      # blocks between wavefront restart points
                                  # (0 = anchor-free v1 semantics)
    anchors: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
                                  # i64[n_anchors] anchor block ids, sorted,
                                  # anchors[0] == 0 when non-empty
    block_depth: Optional[np.ndarray] = None
                                  # i32[n_blocks] exact pointer-doubling
                                  # rounds each block needs (v3 header);
                                  # None = legacy archive, depth unknown
    parity_group: int = 0         # blocks per XOR-parity group (v4 header;
                                  # 0 = no parity protection)
    parity_words: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint16))
                                  # u16 flat parity rows, group g at
                                  # parity_words[parity_off[g]:parity_off[g+1]]
    parity_off: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(1, np.int64))
                                  # i64[n_groups+1] prefix offsets

    @property
    def n_blocks(self) -> int:
        return int(self.block_start.shape[0])

    @property
    def n_parity_groups(self) -> int:
        return max(0, int(self.parity_off.shape[0]) - 1)

    @property
    def max_depth(self) -> Optional[int]:
        """Archive-wide resolve-round bound (None when depth is unknown —
        legacy archives decode through the early-exit resolver)."""
        if self.block_depth is None:
            return None
        return int(self.block_depth.max(initial=0))

    @property
    def n_anchors(self) -> int:
        return int(self.anchors.shape[0])

    @property
    def compressed_bytes(self) -> int:
        """On-the-wire size: words + tables + headers (what VRAM residency costs)."""
        return (self.words.size * 2
                + self.freqs.size * 2
                + self.word_off.size * 8
                + self.n_words.size * 4
                + self.n_syms.size * 4
                + self.lanes.size * 4
                + self.n_cmds.size * 4
                + self.block_start.size * 8
                + self.block_len.size * 4
                + self.block_fnv.size * 8
                + self.anchors.size * 8
                + (self.block_depth.size * 4
                   if self.block_depth is not None else 0)
                + self.parity_words.size * 2
                + (self.parity_off.size * 8 if self.parity_group else 0)
                + 64)  # fixed header

    @property
    def ratio(self) -> float:
        return self.raw_size / max(1, self.compressed_bytes)


MAGIC_V1 = b"ACEJAX02"            # anchor-free layout (no anchor tail)
MAGIC_V2 = b"ACEJAX03"            # v2: v1 layout + anchor table tail
MAGIC = b"ACEJAX04"               # v3: v2 layout + block-depth tail
MAGIC_V4 = b"ACEJAX05"            # v4: v3 layout + XOR-parity tail


def block_payload_bounds(a: Archive) -> tuple:
    """Per-block payload word range: block b's compressed payload is
    `a.words[starts[b]:ends[b]]`. Both entropy backends lay the four
    streams of each block contiguously and in block order, so the range
    is [word_off[b, 0], word_off[b+1, 0]) with the last block ending at
    `words.size` — the unit both the parity groups and the shard
    partitioner operate on."""
    starts = np.ascontiguousarray(a.word_off[:, 0], np.int64)
    ends = np.append(starts[1:], np.int64(a.words.size))
    return starts, ends


def serialize(a: Archive) -> bytes:
    """Flat binary serialization. All size/offset fields are u64 — the
    paper §5 overflow fix (u32 size fields migrated to 64-bit) is enforced
    at the format level. Writes the v3 (`ACEJAX04`) layout: the v1 body
    followed by the anchor table (interval + anchor block ids) and the
    per-block chain-depth table, so a v3 reader accepts v1/v2 archives by
    stopping at the shorter body. An archive whose depth was never
    measured serializes an empty depth table (deserializes back to
    `block_depth is None`). Parity-protected archives write the v4
    (`ACEJAX05`) layout — the v3 body plus the parity tail; parity-free
    archives keep the exact v3 bytes so pre-parity readers still open
    them."""
    import struct
    magic = MAGIC_V4 if a.parity_group else MAGIC
    head = struct.pack(
        "<8sQQQQB3xB3xQ",
        magic, a.block_size, a.raw_size, a.n_blocks, a.words.size,
        {"ra": 0, "global": 1}[a.mode], {"rans": 0, "raw": 1}[a.entropy],
        a.file_fnv,
    )
    parts = [head, struct.pack("<Q", a.offset_bytes)]
    for arr, dt in (
        (a.freqs, np.uint16), (a.words, np.uint16), (a.word_off, np.int64),
        (a.n_words, np.int32), (a.n_syms, np.int32), (a.lanes, np.int32),
        (a.n_cmds, np.int32), (a.block_start, np.int64),
        (a.block_len, np.int32), (a.block_fnv, np.uint64),
    ):
        raw = np.ascontiguousarray(arr, dtype=dt).tobytes()
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
    # v2 anchor tail: interval, then the anchor block-id array
    parts.append(struct.pack("<Q", a.anchor_interval))
    raw = np.ascontiguousarray(a.anchors, dtype=np.int64).tobytes()
    parts.append(struct.pack("<Q", len(raw)))
    parts.append(raw)
    # v3 depth tail: per-block resolve-round table (empty = depth unknown)
    depth = (np.ascontiguousarray(a.block_depth, dtype=np.int32)
             if a.block_depth is not None else np.zeros(0, np.int32))
    raw = depth.tobytes()
    parts.append(struct.pack("<Q", len(raw)))
    parts.append(raw)
    if a.parity_group:
        # v4 parity tail: group size, flat parity words, group offsets
        parts.append(struct.pack("<Q", a.parity_group))
        raw = np.ascontiguousarray(a.parity_words, dtype=np.uint16).tobytes()
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
        raw = np.ascontiguousarray(a.parity_off, dtype=np.int64).tobytes()
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def deserialize(buf: bytes) -> Archive:
    """Parse a serialized archive. Structural damage — wrong magic, a
    truncated buffer, a table whose recorded length does not match its
    shape — raises `CorruptArchiveError` naming the field that failed,
    never an opaque struct/reshape error from inside numpy."""
    import struct
    off = 0

    def take(n, field):
        nonlocal off
        out = buf[off:off + n]
        if len(out) != n:
            raise CorruptArchiveError(
                f"archive truncated in {field}: need {n} bytes at offset "
                f"{off}, have {len(buf) - off}")
        off += n
        return out

    head_fmt = "<8sQQQQB3xB3xQ"
    head = take(struct.calcsize(head_fmt), "header")
    magic, block_size, raw_size, n_blocks, n_words_total, mode_b, ent_b, file_fnv = \
        struct.unpack(head_fmt, head)
    if magic not in (MAGIC_V4, MAGIC, MAGIC_V2, MAGIC_V1):
        raise CorruptArchiveError(f"bad magic {magic!r}")
    version = {MAGIC_V4: 4, MAGIC: 3, MAGIC_V2: 2, MAGIC_V1: 1}[magic]
    if mode_b not in (0, 1):
        raise CorruptArchiveError(f"bad mode byte {mode_b}")
    if ent_b not in (0, 1):
        raise CorruptArchiveError(f"bad entropy byte {ent_b}")
    if n_blocks > len(buf):
        # cheap sanity bound: every block costs >= 1 byte of tables, so a
        # count past the buffer size is garbage, not a huge archive
        raise CorruptArchiveError(
            f"implausible n_blocks {n_blocks} for a {len(buf)}-byte buffer")
    (offset_bytes,) = struct.unpack("<Q", take(8, "offset_bytes"))

    def arr(dt, shape, field):
        (nb,) = struct.unpack("<Q", take(8, f"{field} length"))
        if nb > len(buf) - off:
            raise CorruptArchiveError(
                f"archive truncated in {field}: recorded {nb} bytes, "
                f"{len(buf) - off} remain")
        item = np.dtype(dt).itemsize
        if nb % item:
            raise CorruptArchiveError(
                f"{field}: {nb} bytes is not a multiple of itemsize {item}")
        a = np.frombuffer(take(nb, field), dtype=dt).copy()
        want = int(np.prod([s for s in shape if s >= 0]))
        if -1 not in shape and a.size != want:
            raise CorruptArchiveError(
                f"{field}: expected {want} entries for shape {shape}, "
                f"got {a.size}")
        return a.reshape(shape)

    freqs = arr(np.uint16, (N_STREAMS, 256), "freqs")
    words = arr(np.uint16, (-1,), "words")
    if words.size != n_words_total:
        raise CorruptArchiveError(
            f"words: header records {n_words_total} words, body has "
            f"{words.size}")
    word_off = arr(np.int64, (n_blocks, N_STREAMS), "word_off")
    n_words = arr(np.int32, (n_blocks, N_STREAMS), "n_words")
    n_syms = arr(np.int32, (n_blocks, N_STREAMS), "n_syms")
    lanes = arr(np.int32, (n_blocks, N_STREAMS), "lanes")
    n_cmds = arr(np.int32, (n_blocks,), "n_cmds")
    block_start = arr(np.int64, (n_blocks,), "block_start")
    block_len = arr(np.int32, (n_blocks,), "block_len")
    block_fnv = arr(np.uint64, (n_blocks,), "block_fnv")
    if version >= 2:
        (anchor_interval,) = struct.unpack("<Q", take(8, "anchor_interval"))
        anchors = arr(np.int64, (-1,), "anchors")
    else:                           # v1: anchor-free by definition
        anchor_interval = 0
        anchors = np.zeros(0, np.int64)
    block_depth = None
    if version >= 3:                # v3: per-block chain-depth table
        depth = arr(np.int32, (-1,), "block_depth")
        block_depth = depth if depth.size else None
    parity_group = 0
    parity_words = np.zeros(0, np.uint16)
    parity_off = np.zeros(1, np.int64)
    if version >= 4:                # v4: XOR-parity tail
        (parity_group,) = struct.unpack("<Q", take(8, "parity_group"))
        parity_words = arr(np.uint16, (-1,), "parity_words")
        parity_off = arr(np.int64, (-1,), "parity_off")
        if parity_group:
            n_groups = -(-n_blocks // parity_group)
            if parity_off.size != n_groups + 1:
                raise CorruptArchiveError(
                    f"parity_off: expected {n_groups + 1} offsets for "
                    f"{n_blocks} blocks in groups of {parity_group}, got "
                    f"{parity_off.size}")
            if parity_off.size and int(parity_off[-1]) != parity_words.size:
                raise CorruptArchiveError(
                    f"parity_words: offsets end at {int(parity_off[-1])}, "
                    f"buffer has {parity_words.size} words")
    return Archive(
        block_size=block_size, raw_size=raw_size,
        mode={0: "ra", 1: "global"}[mode_b],
        entropy={0: "rans", 1: "raw"}[ent_b],
        freqs=freqs, words=words, word_off=word_off, n_words=n_words,
        n_syms=n_syms, lanes=lanes, n_cmds=n_cmds, block_start=block_start,
        block_len=block_len, block_fnv=block_fnv, file_fnv=file_fnv,
        offset_bytes=int(offset_bytes),
        anchor_interval=int(anchor_interval), anchors=anchors,
        block_depth=block_depth,
        parity_group=int(parity_group), parity_words=parity_words,
        parity_off=parity_off,
    )
