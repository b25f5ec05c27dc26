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

Resolving a `Region` needs the device-resident name table, which comes
with a later slice of the PyTorch port.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Union

import numpy as np


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
    half-open; None = record boundary)."""
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
