"""Typed address spaces for the unified query plane (paper §4).

Every decode request is an *address* in one of three spaces:

  ReadId(i)              — the i-th record of the indexed corpus
  ByteRange(lo, hi)      — absolute decompressed output bytes [lo, hi)
  Region(name, s, e)     — a `samtools faidx`-style named region: bytes
                           [s, e) *within* the record called `name`

`parse_region` accepts the familiar text forms (`"SRR0.7"`,
`"SRR0.7:100"`, `"SRR0.7:100-200"`, 1-based inclusive like samtools) and
lowers them to the 0-based half-open `Region` used internally. NOTE the
coordinate space: region offsets index the record's RAW BYTES (header
line + sequence + separator + quality), not sequence bases — this store
addresses byte payloads; `samtools faidx` is the comparison for the
name→location index, not for base-coordinate arithmetic. When resolving
a string address against a name table, the FULL string is tried as a
record name first (samtools precedence), so Illumina-style names ending
in numeric `:x:y` fields are not mis-split.

`NameTable` is the device-resident name→read-id table (`FaiIndex`
semantics on the card): names are FNV-1a-64 hashed on the host, the
sorted (hash, read id) table lives in device memory, and a batch of
lookups resolves with one `torch.searchsorted`, so a named query takes
the same device start-table path `fetch_reads` uses.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence, Union

import numpy as np
import torch


# ------------------------------------------------------------- address types
@dataclasses.dataclass(frozen=True)
class ReadId:
    """The i-th record of the corpus (requires a ReadIndex)."""
    i: int


@dataclasses.dataclass(frozen=True)
class ByteRange:
    """Absolute decompressed output bytes [lo, hi)."""
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class Region:
    """Bytes [start, end) within the record called `name` (0-based
    half-open; None = record boundary). Requires a NameTable."""
    name: bytes
    start: Optional[int] = None
    end: Optional[int] = None


Address = Union[ReadId, ByteRange, Region, int, slice, str, bytes]

_REGION_SUFFIX = re.compile(rb"^(\d+)(?:-(\d*))?$")


def parse_region(text: Union[str, bytes]) -> Region:
    """`"name"` / `"name:100"` / `"name:100-"` / `"name:100-200"` → Region.

    Coordinates follow `samtools faidx`: 1-based, inclusive, with the
    open-ended `100-` form meaning "to the end of the record". Only a
    trailing `:<digits>[-<digits>]` is treated as a coordinate suffix, so
    Illumina-style names containing colons still parse as plain names.
    """
    raw = text.encode() if isinstance(text, str) else bytes(text)
    name, sep, tail = raw.rpartition(b":")
    if sep:
        m = _REGION_SUFFIX.match(tail)
        if m:
            start1 = int(m.group(1))
            if start1 < 1:
                raise ValueError(f"region start is 1-based: {text!r}")
            end1 = int(m.group(2)) if m.group(2) else None
            if end1 is not None and end1 < start1:
                raise ValueError(f"empty/inverted region: {text!r}")
            return Region(name=name, start=start1 - 1, end=end1)
    return Region(name=raw)


# --------------------------------------------------------- name → id lookup
_SIGN = np.uint64(1 << 63)


def _fnv1a64(name: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in name:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _sorted_keys(names: Sequence[bytes]) -> np.ndarray:
    """u64 FNV-1a hashes (Python ints, as torch has no u64 arithmetic) with
    the sign bit flipped and read as i64, so signed order is the hashes'
    unsigned order."""
    h = np.fromiter((_fnv1a64(bytes(nm)) for nm in names), np.uint64,
                    count=len(names))
    return (h ^ _SIGN).view(np.int64)


class NameTable:
    """Device-resident name→read-id table (the `.fai` name column, on the
    card by default). Build once from the corpus names; `lookup` resolves
    a batch of names to read ids with one device search. 64-bit hash
    collisions and duplicate names are rejected at build time."""

    def __init__(self, keys: torch.Tensor, ids: torch.Tensor, n_names: int):
        self.keys = keys              # i64[n] sorted, sign-flipped hashes
        self.ids = ids                # i32[n] read id per sorted slot
        self.n_names = n_names

    @property
    def device_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.keys, self.ids))

    @classmethod
    def build(cls, names: Sequence[bytes], device="cuda") -> "NameTable":
        n = len(names)
        keys = _sorted_keys(names)
        order = np.argsort(keys, kind="stable")
        ks = keys[order]
        dup = np.flatnonzero(ks[1:] == ks[:-1]) if n > 1 else np.array([], int)
        if dup.size:
            a, b = int(order[dup[0]]), int(order[dup[0] + 1])
            if names[a] != names[b]:
                raise ValueError(
                    f"64-bit name-hash collision: {names[a]!r} vs "
                    f"{names[b]!r}; rename one record")
            raise ValueError(f"duplicate record name {names[a]!r} "
                             f"(ids {a} and {b}); names must be unique")
        from repro_torch.core.decoder import resolve_device
        dev = resolve_device(device)
        return cls(keys=torch.from_numpy(ks).to(dev),
                   ids=torch.from_numpy(order.astype(np.int32)).to(dev),
                   n_names=n)

    def lookup(self, names: Sequence[bytes],
               missing_ok: bool = False) -> np.ndarray:
        """names → i32 read ids (device lookup). KeyError on any miss
        unless `missing_ok`, in which case misses resolve to -1."""
        q = [bytes(nm) for nm in names]
        if not q:
            return np.zeros(0, np.int32)
        if self.n_names == 0:
            if missing_ok:
                return np.full(len(q), -1, np.int32)
            raise KeyError(f"name table is empty; no record named {q[0]!r}")
        qk = torch.from_numpy(_sorted_keys(q)).to(self.keys.device)
        pos = torch.searchsorted(self.keys, qk).clamp(max=self.n_names - 1)
        rid = torch.where(self.keys[pos] == qk, self.ids[pos], -1)
        rid = rid.cpu().numpy().astype(np.int32)
        missing = np.flatnonzero(rid < 0)
        if missing.size and not missing_ok:
            raise KeyError(
                f"no record named {q[int(missing[0])]!r} "
                f"({missing.size} of {len(q)} names unresolved)")
        return rid


def normalize(addr: Address) -> Union[ReadId, ByteRange, Region]:
    """Python-native forms → typed addresses (ints are read ids, slices are
    byte ranges, strings parse as regions)."""
    if isinstance(addr, (ReadId, ByteRange, Region)):
        return addr
    if isinstance(addr, (int, np.integer)):
        return ReadId(int(addr))
    if isinstance(addr, slice):
        if addr.step not in (None, 1):
            raise ValueError("strided byte slices are not addressable")
        if addr.start is None or addr.stop is None:
            raise ValueError("byte-range slices need explicit start and stop")
        return ByteRange(int(addr.start), int(addr.stop))
    if isinstance(addr, (str, bytes)):
        return parse_region(addr)
    raise TypeError(f"not an address: {addr!r}")
