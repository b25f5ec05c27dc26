"""`GenomicArchive` — the one facade over the query plane.

    ga = GenomicArchive.from_bytes(fastq_bytes)        # encode + index,
                                                       # on the card
    rows, lens = ga.query([ReadId(7), "SRR0.9:10-60"]) # one DecodePlan
    for chunk in ga.stream([ByteRange(0, ga.raw_size)],
                           max_resident_bytes=1 << 20):
        ...                                            # budgeted decode
    ga[1000:2000]     # absolute byte slice       ga[7]      # read bytes
    ga["SRR0.9:10-60"]                            # named region bytes

Every address — read id, byte offset, or `samtools faidx`-style named
region — resolves through the same compact index to the same
covering-block decode (the paper's position-invariant random access).
The builders take `device=` (default the card); every query runs on the
device the archive lives on.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.api.address import Address, NameTable
from repro_torch.api.executors import DeviceExecutor, StreamingExecutor
from repro_torch.api.plan import DecodePlan, QueryPlanner


class GenomicArchive:
    """Compressed-resident archive + index + name table behind one query
    surface. Wraps an existing `CompressedResidentStore` (use `from_bytes`
    / `from_records` / `create` / `open` to build everything)."""

    profile = None   # the EncodeProfile `create` tuned/used, when built
                     # through the autotuned path

    def __init__(self, store, names: Optional[Sequence[bytes]] = None,
                 name_table: Optional[NameTable] = None):
        self.store = store
        self._raw_names = [bytes(n) for n in names] if names else None
        if name_table is None and names is not None:
            name_table = NameTable.build(names, device=store.device)
        self.names = name_table
        self.planner = QueryPlanner(store, name_table)
        self.executor = DeviceExecutor(store)

    # ------------------------------------------------------------ builders
    @classmethod
    def from_bytes(cls, data: bytes, block_size: int = 16 * 1024,
                   mode: str = "ra", entropy: str = "rans", device="cuda",
                   cache_blocks: int = 0, cache_policy="lru",
                   anchor_interval: int = 0, parity_group: int = 0,
                   verify: bool = False, on_error: str = "raise",
                   profile=None) -> "GenomicArchive":
        """FASTQ bytes → encoded archive + ReadIndex + device name table on
        `device`. cache_blocks > 0 enables the device-resident
        decoded-block cache ("lru" | "freq" | "tinylfu" | an
        `EvictionPolicy`). `anchor_interval` (global mode) emits a
        wavefront restart point every that many blocks, so point queries
        decode one anchor window instead of the whole prefix.
        `parity_group=k` stores one XOR parity row per k compressed blocks
        (the `ACEJAX05` tail): any single corrupt block of a group heals
        on the device under `on_error="repair"`. `verify`/`on_error` are
        the store's defaults for every query. `profile` (a
        `repro_torch.tune.EncodeProfile`, e.g. from `autotune`) supplies
        every encode knob at once — pass it INSTEAD of
        block_size/mode/entropy/anchor_interval."""
        from repro_torch.core.encoder import encode
        from repro_torch.core.index import ReadIndex, parse_fastq_records
        from repro_torch.core.residency import CompressedResidentStore
        starts, names = parse_fastq_records(data)
        archive = encode(data, block_size=block_size, mode=mode,
                         entropy=entropy, anchor_interval=anchor_interval,
                         parity_group=parity_group, profile=profile)
        index = ReadIndex(starts=starts, block_size=archive.block_size)
        store = CompressedResidentStore(archive, index, device=device,
                                        cache_blocks=cache_blocks,
                                        cache_policy=cache_policy,
                                        verify=verify, on_error=on_error)
        return cls(store, names=names)

    @classmethod
    def from_records(cls, data: bytes, record_bytes: int,
                     block_size: int = 16 * 1024, mode: str = "ra",
                     entropy: str = "rans", device="cuda",
                     cache_blocks: int = 0, cache_policy="lru",
                     anchor_interval: int = 0, parity_group: int = 0,
                     verify: bool = False, on_error: str = "raise",
                     profile=None) -> "GenomicArchive":
        """Fixed-size records (tokenized corpora): arithmetic index, no
        names. `data` is cut to a whole number of records. The other
        arguments are those of `from_bytes`."""
        from repro_torch.core.encoder import encode
        from repro_torch.core.index import ReadIndex
        from repro_torch.core.residency import CompressedResidentStore
        n_rec = len(data) // record_bytes
        if n_rec == 0:
            raise ValueError("corpus smaller than one record")
        data = data[:n_rec * record_bytes]
        archive = encode(data, block_size=block_size, mode=mode,
                         entropy=entropy, anchor_interval=anchor_interval,
                         parity_group=parity_group, profile=profile)
        index = ReadIndex.fixed_records(n_rec, record_bytes,
                                        archive.block_size)
        store = CompressedResidentStore(archive, index, device=device,
                                        cache_blocks=cache_blocks,
                                        cache_policy=cache_policy,
                                        verify=verify, on_error=on_error)
        return cls(store)

    @classmethod
    def create(cls, data: bytes, target: str = "seek",
               latency_budget_us: Optional[float] = None,
               record_bytes: Optional[int] = None,
               sample_bytes: int = 1 << 20, device="cuda",
               cache_blocks: int = 0, cache_policy="lru",
               profile=None, **tune_kwargs) -> "GenomicArchive":
        """Autotuned builder: sweep the encode knob grid on a bounded
        sample of `data`, pick the Pareto point for the declared objective
        (`target` = "seek" | "ratio" | "throughput", or a
        `latency_budget_us` meaning best ratio whose seek fits the
        budget), then encode the full corpus with the winning
        `EncodeProfile`. The sweep measures on `device`, where the archive
        then lives. Pass `profile=` to skip the sweep and reuse a
        previously tuned profile. `record_bytes` routes to `from_records`
        (fixed-size records) instead of FASTQ parsing. The chosen profile
        is exposed as `ga.profile`."""
        if profile is None:
            from repro_torch.tune import autotune
            result = autotune(data, target=target,
                              latency_budget_us=latency_budget_us,
                              sample_bytes=sample_bytes, device=device,
                              **tune_kwargs)
            profile = result.profile
        if record_bytes is not None:
            ga = cls.from_records(data, record_bytes, device=device,
                                  cache_blocks=cache_blocks,
                                  cache_policy=cache_policy, profile=profile)
        else:
            ga = cls.from_bytes(data, device=device,
                                cache_blocks=cache_blocks,
                                cache_policy=cache_policy, profile=profile)
        ga.profile = profile
        return ga

    # ------------------------------------------------------- persistence
    _DISK_MAGIC = b"ACEGADS1"     # facade container: archive + index sidecar

    def save(self, path: str) -> int:
        """Persist the encoded archive + index metadata to one file (the
        reference's `ACEGADS1` container, byte for byte). Returns bytes
        written. Layout: magic, u32 JSON-header length, header (record
        geometry + record names), serialized archive."""
        from repro_torch.core.format import serialize
        hdr: dict = {}
        index = self.store.index
        if index is not None:
            starts = index.starts.astype(np.int64)
            lens = np.diff(starts)
            if lens.size and bool((lens == lens[0]).all()) \
                    and int(starts[0]) == 0:
                hdr["record_bytes"] = int(lens[0])
                hdr["n_records"] = int(lens.size)
            else:
                hdr["starts"] = [int(x) for x in starts]
        if self._raw_names is not None:
            hdr["names"] = [n.decode("latin-1") for n in self._raw_names]
        head = json.dumps(hdr).encode()
        payload = serialize(self.store.decoder.archive)
        blob = self._DISK_MAGIC + struct.pack("<I", len(head)) + head \
            + payload
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        return len(blob)

    @classmethod
    def open(cls, path: str, device="cuda", cache_blocks: int = 0,
             cache_policy="lru", verify: bool = False,
             on_error: str = "raise") -> "GenomicArchive":
        """Open an archive written by `save` (by either package):
        deserialize the compressed payload, rebuild the read index and name
        table, ship to `device`. Every container field validates before
        any slice is trusted: a truncated, wrong-magic or header-mangled
        file raises `CorruptArchiveError` naming what failed."""
        from repro_torch.core.format import CorruptArchiveError, deserialize
        from repro_torch.core.index import ReadIndex
        from repro_torch.core.residency import CompressedResidentStore
        with open(path, "rb") as f:
            blob = f.read()
        if len(blob) < 12:
            raise CorruptArchiveError(
                f"{path}: truncated container ({len(blob)} bytes; the "
                f"magic + header-length prelude alone is 12)")
        if blob[:8] != cls._DISK_MAGIC:
            raise CorruptArchiveError(
                f"{path}: not a GenomicArchive.save file "
                f"(magic {blob[:8]!r}, expected {cls._DISK_MAGIC!r})")
        (hlen,) = struct.unpack_from("<I", blob, 8)
        if 12 + hlen > len(blob):
            raise CorruptArchiveError(
                f"{path}: header length {hlen} overruns the "
                f"{len(blob)}-byte container")
        try:
            hdr = json.loads(blob[12:12 + hlen].decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise CorruptArchiveError(
                f"{path}: container header is not valid JSON ({e})") from e
        if not isinstance(hdr, dict):
            raise CorruptArchiveError(
                f"{path}: container header decodes to "
                f"{type(hdr).__name__}, expected an object")
        if 12 + hlen == len(blob):
            raise CorruptArchiveError(
                f"{path}: container carries no archive payload after the "
                f"header")
        archive = deserialize(blob[12 + hlen:])
        index = None
        if "record_bytes" in hdr:
            index = ReadIndex.fixed_records(int(hdr["n_records"]),
                                            int(hdr["record_bytes"]),
                                            archive.block_size)
        elif "starts" in hdr:
            starts = np.asarray(hdr["starts"], np.uint64)
            if starts.size == 0 or int(starts[-1]) != archive.raw_size:
                raise CorruptArchiveError(
                    f"{path}: read-index starts end at "
                    f"{int(starts[-1]) if starts.size else 'nothing'} but "
                    f"the archive decodes {archive.raw_size} bytes")
            index = ReadIndex(starts=starts, block_size=archive.block_size)
        store = CompressedResidentStore(archive, index, device=device,
                                        cache_blocks=cache_blocks,
                                        cache_policy=cache_policy,
                                        verify=verify, on_error=on_error)
        names = ([n.encode("latin-1") for n in hdr["names"]]
                 if "names" in hdr else None)
        return cls(store, names=names)

    # ------------------------------------------------------------- queries
    def plan(self, addrs: Sequence[Address]) -> DecodePlan:
        return self.planner.plan(addrs)

    def dataset(self, batch_size: int = 8, seq_len: Optional[int] = None,
                sampler="uniform", prefetch: int = 2, seed: int = 0,
                sync_ready: bool = True, verify: Optional[bool] = None,
                on_error: Optional[str] = None):
        """Training-grade loader over this archive: an `ArchiveDataset`
        whose batches are int32 `{"tokens", "labels"}` tensors on the
        archive's device, every batch one DecodePlan through this query
        plane, decoded `prefetch` batches ahead on a worker (see
        `repro_torch.api.dataset`). `seq_len` defaults to the fixed
        record size minus one; variable-length records need it, and are
        cut or zero-padded to `seq_len + 1` bytes."""
        from repro_torch.api.dataset import ArchiveDataset
        return ArchiveDataset(self, batch_size=batch_size, seq_len=seq_len,
                              sampler=sampler, prefetch=prefetch, seed=seed,
                              sync_ready=sync_ready, verify=verify,
                              on_error=on_error)

    def query(self, addrs: Sequence[Address], mode2: bool = True,
              verify: Optional[bool] = None, on_error: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Any batch of addresses → ((B, max_len) u8 zero-padded payloads,
        (B,) i32 lengths) on the device: one DecodePlan, one execution.
        `verify`/`on_error` override the store defaults for this call."""
        if not isinstance(addrs, np.ndarray) and len(addrs) == 0:
            dev = self.store.device
            return (torch.zeros((0, 1), dtype=torch.uint8, device=dev),
                    torch.zeros((0,), dtype=torch.int32, device=dev))
        return self.executor.run(self.planner.plan(addrs), mode2=mode2,
                                 verify=verify, on_error=on_error)

    def query_bytes(self, addr: Address, mode2: bool = True) -> np.ndarray:
        """Single address → exact payload bytes (host u8 array)."""
        rows, lens = self.query([addr], mode2=mode2)
        return rows[0, :int(lens[0])].cpu().numpy()

    def stream(self, addrs: Sequence[Address], max_resident_bytes: int,
               mode2: bool = True, verify: bool = False,
               on_error: str = "raise") -> Iterator[np.ndarray]:
        """Budgeted decode of queries of ANY size: yields host u8 chunks
        whose concatenation is the concatenated payloads. Each chunk's
        decoded rows + gather output stay within `max_resident_bytes`;
        the decode's own temporaries come on top (3.5x the budget above
        residency for "ra" at 16 KiB blocks on an H100, see
        `StreamingExecutor`), and the peak does not grow with the output.
        `verify=True` checks per-block digests on the device before each
        chunk is cropped to spans; `on_error` picks the recovery semantics
        (raise `BlockDigestError` | parity `"repair"` | `"partial"`)."""
        ex = StreamingExecutor(self.store,
                               max_resident_bytes=max_resident_bytes,
                               mode2=mode2, planner=self.planner,
                               verify=verify, on_error=on_error)
        return ex.chunks(addrs)

    def __getitem__(self, key: Union[Address, slice]) -> np.ndarray:
        """`ga[lo:hi]` absolute bytes; `ga[i]` read i; `ga["name:s-e"]`
        named region (strings resolve full-name-first, like samtools)."""
        return self.query_bytes(key)

    def __len__(self) -> int:
        return self.n_reads

    # --------------------------------------------------------------- sugar
    @property
    def raw_size(self) -> int:
        return self.store.decoder.da.raw_size

    @property
    def n_reads(self) -> int:
        return self.store.index.n_reads if self.store.index else 0

    @property
    def block_size(self) -> int:
        return self.store.block_size

    def stats(self):
        return self.store.stats()

    def cache_info(self) -> dict:
        """Decoded-block cache counters: hits/misses/evictions/installs,
        bytes_resident, decode_launches, policy (zeros when disabled)."""
        return self.store.cache_info()

    def recover_info(self) -> dict:
        """Recovery counters of the underlying decoder: blocks
        parity-`reconstructed`, decode `retries`, `unrecoverable`
        failures, and currently `quarantined` blocks."""
        return self.store.decoder.recover_info()

    @property
    def last_corrupt(self) -> np.ndarray:
        """Per-address corrupt mask of the most recent query (bool[B];
        all False unless `on_error="partial"` met unrecoverable blocks)."""
        return self.executor.last_corrupt

    def __repr__(self) -> str:
        st = self.stats()
        named = self.names.n_names if self.names else 0
        return (f"GenomicArchive({st.raw_size:,}B raw → "
                f"{st.compressed_device_bytes:,}B device-resident, "
                f"{st.n_blocks} blocks, {self.n_reads} reads, "
                f"{named} named)")
