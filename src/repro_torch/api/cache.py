"""Device-resident decoded-block cache, planned at the DecodePlan level.

  * one preallocated (capacity, block_size) u8 buffer lives on the store's
    device; decoded bytes never leave it,
  * a host block-id → slot map splits a plan's unique covering set into
    hit slots and miss blocks with vectorized numpy (`CachePlan`, defined
    next to `DecodePlan` in `repro_torch.api.plan`),
  * the miss set decodes in ONE pow2-padded decode call (one launch per
    depth bucket), and
  * one `index_copy_` installs the admitted rows in place and one
    `index_select` per source assembles the (U, block_size) row tensor
    the ragged gather consumes. The reference does this with a jitted
    scatter/gather on a donated buffer; it has no Pallas kernel there, so
    neither does the port.

Eviction/admission is pluggable and runs on the host in numpy:
`LRUPolicy` (recency), `FrequencyPolicy` (admission after k sightings),
`TinyLFUPolicy` (doorkeeper + aged 4-bit count-min sketch) and
`PinRangePolicy` (a pinned block range never evicts).

Checkpointed-wavefront ("global" + anchors) archives compose here too:
slots stay keyed by block id — a block decodes to the same bytes
whichever anchor window materialized it — while the miss decode groups
the miss set by anchor window. The window rows the miss decode
materialized beyond the requested blocks co-install into free slots
(`install_extras`), so a scan over a window costs one decode.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.api.plan import CachePlan, split_cache_hits
from repro_torch.core.decoder import _not_in_slice, _pad_pow2


# ------------------------------------------------------------------ policies
class EvictionPolicy:
    """Pluggable eviction/admission. The cache calls, in order per access:

      bind(cache)                 once — size per-slot/per-block state
      admit(miss_blocks) → mask   which missed blocks may claim a slot
      victims(k, evictable) → slots   up to k slots to evict, chosen from
                                  the boolean `evictable` mask (never a
                                  slot the current request reads)
      touch(slots, blocks)        every access (hits + fresh installs)
    """

    name = "none"

    def bind(self, cache: "BlockCache") -> None:
        self.cache = cache

    def admit(self, miss_blocks: np.ndarray) -> np.ndarray:
        return np.ones(miss_blocks.size, bool)

    def victims(self, k: int, evictable: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def touch(self, slots: np.ndarray, blocks: np.ndarray) -> None:
        pass


class LRUPolicy(EvictionPolicy):
    """Least-recently-used eviction, admit-everything."""

    name = "lru"

    def bind(self, cache: "BlockCache") -> None:
        super().bind(cache)
        self._last = np.zeros(cache.capacity, np.int64)
        self._tick = 0

    def victims(self, k: int, evictable: np.ndarray) -> np.ndarray:
        cand = np.flatnonzero(evictable)
        return cand[np.argsort(self._last[cand], kind="stable")[:k]]

    def touch(self, slots: np.ndarray, blocks: np.ndarray) -> None:
        self._tick += 1
        self._last[slots] = self._tick


class FrequencyPolicy(LRUPolicy):
    """Frequency-aware admission + least-frequency eviction (LRU
    tie-break). A missed block is admitted only once it has been requested
    `admit_after` times — under a Zipfian serving working set the hot head
    recurs immediately while the cold tail's one-hit wonders never earn a
    slot, so they cannot thrash the resident head."""

    name = "freq"

    def __init__(self, admit_after: int = 2):
        self.admit_after = int(admit_after)

    def bind(self, cache: "BlockCache") -> None:
        super().bind(cache)
        self._freq = np.zeros(cache.n_blocks, np.int64)

    def admit(self, miss_blocks: np.ndarray) -> np.ndarray:
        self._freq[miss_blocks] += 1          # count the sighting itself
        return self._freq[miss_blocks] >= self.admit_after

    def victims(self, k: int, evictable: np.ndarray) -> np.ndarray:
        cand = np.flatnonzero(evictable)
        blocks = self.cache.slot_block[cand]
        order = np.lexsort((self._last[cand], self._freq[blocks]))
        return cand[order[:k]]

    def touch(self, slots: np.ndarray, blocks: np.ndarray) -> None:
        super().touch(slots, blocks)
        self._freq[blocks] += 1


class FrequencySketch:
    """4-bit count-min sketch over block ids — the TinyLFU frequency
    table. `n_hash` rows of a pow2 `width` hold saturating 0..15
    counters; `halve()` ages every counter (>> 1), so stale popularity
    decays geometrically instead of accumulating forever (the failure
    mode of a monotone count like `FrequencyPolicy._freq`: yesterday's
    hot head outvotes today's flash crowd indefinitely). All adds and
    estimates are vectorized over the key batch."""

    _MIX = np.array([0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F,
                     0x165667B19E3779F9, 0xD6E8FEB86659FD93], np.uint64)

    def __init__(self, n_keys: int, n_hash: int = 4):
        if n_keys <= 0:
            raise ValueError(f"n_keys must be positive, got {n_keys}")
        self.width = 1 << max(4, int(n_keys - 1).bit_length())
        self.n_hash = min(max(1, int(n_hash)), len(self._MIX))
        self.table = np.zeros((self.n_hash, self.width), np.uint8)
        self.halvings = 0

    def _slots(self, keys: np.ndarray) -> np.ndarray:
        k = np.asarray(keys, np.uint64)[None, :]
        with np.errstate(over="ignore"):
            h = k * self._MIX[:self.n_hash, None]
            h ^= h >> np.uint64(31)
            h *= np.uint64(0xFF51AFD7ED558CCD)
            h ^= h >> np.uint64(33)
        return (h & np.uint64(self.width - 1)).astype(np.int64)

    def add(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys, np.int64).reshape(-1)
        if keys.size == 0:
            return
        idx = self._slots(keys)
        for r in range(self.n_hash):
            bump = np.bincount(idx[r], minlength=self.width)
            row = self.table[r] + np.minimum(bump, 15)
            self.table[r] = np.minimum(row, 15).astype(np.uint8)

    def estimate(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.int64).reshape(-1)
        if keys.size == 0:
            return np.zeros(0, np.int64)
        idx = self._slots(keys)
        est = self.table[0][idx[0]].astype(np.int64)
        for r in range(1, self.n_hash):
            np.minimum(est, self.table[r][idx[r]], out=est)
        return est

    def halve(self) -> None:
        self.table >>= 1
        self.halvings += 1


class TinyLFUPolicy(LRUPolicy):
    """TinyLFU admission (doorkeeper + aged 4-bit sketch) with
    lowest-estimated-frequency eviction, LRU recency as the tie-break.

    Every sighting of a block — miss, hit, or install — feeds the
    filter: the first sighting sets the block's doorkeeper bit (one-hit
    wonders live and die there, never polluting the sketch), repeat
    sightings bump the count-min sketch. Every `sample_factor *
    capacity` sightings the sketch HALVES and the doorkeeper clears —
    the aging step the static `FrequencyPolicy.admit_after` lacks, so a
    formerly-hot working set decays into evictability instead of
    squatting on slots while a flash crowd is turned away. A missed
    block is admitted when free slots remain, or when its estimated
    frequency strictly beats the weakest resident block's (the victim
    it would displace) — the sketch-vs-victim comparison that lets a
    sustained hot-key shift win slots within a few sightings."""

    name = "tinylfu"

    def __init__(self, n_hash: int = 4, sample_factor: int = 8):
        if sample_factor <= 0:
            raise ValueError(
                f"sample_factor must be positive, got {sample_factor}")
        self.n_hash = int(n_hash)
        self.sample_factor = int(sample_factor)

    def bind(self, cache: "BlockCache") -> None:
        super().bind(cache)
        self.sketch = FrequencySketch(cache.n_blocks, self.n_hash)
        self.door = np.zeros(cache.n_blocks, bool)
        self.window = max(1, self.sample_factor * cache.capacity)
        self._ops = 0

    # ----------------------------------------------------------- filter
    def record(self, blocks: np.ndarray) -> None:
        """Count a batch of sightings: doorkeeper first, then sketch;
        halve + clear once the sample window fills."""
        blocks = np.asarray(blocks, np.int64).reshape(-1)
        if blocks.size == 0:
            return
        fresh = ~self.door[blocks]
        self.door[blocks[fresh]] = True
        seen = blocks[~fresh]
        if seen.size:
            self.sketch.add(seen)
        self._ops += int(blocks.size)
        if self._ops >= self.window:
            self.sketch.halve()
            self.door[:] = False
            self._ops = 0

    def estimate(self, blocks: np.ndarray) -> np.ndarray:
        blocks = np.asarray(blocks, np.int64).reshape(-1)
        return self.sketch.estimate(blocks) + self.door[blocks]

    # ----------------------------------------------------- policy hooks
    def admit(self, miss_blocks: np.ndarray) -> np.ndarray:
        self.record(miss_blocks)
        resident = self.cache.slot_block[self.cache.slot_block >= 0]
        if resident.size == 0:
            return np.ones(miss_blocks.size, bool)
        est = self.estimate(miss_blocks)
        victim = int(self.estimate(resident).min())
        mask = est > victim
        # free slots cost nobody anything: top the admitted set up to the
        # free-slot count (plan() hands free slots to admitted misses
        # first, so the topped-up extras never trigger an eviction)
        extra = (self.cache.capacity - resident.size) - int(mask.sum())
        if extra > 0:
            mask[np.flatnonzero(~mask)[:extra]] = True
        return mask

    def victims(self, k: int, evictable: np.ndarray) -> np.ndarray:
        cand = np.flatnonzero(evictable)
        if cand.size == 0:
            return np.zeros(0, np.int64)
        est = self.estimate(self.cache.slot_block[cand])
        order = np.lexsort((self._last[cand], est))
        return cand[order[:k]]

    def touch(self, slots: np.ndarray, blocks: np.ndarray) -> None:
        super().touch(slots, blocks)   # LRU recency tick
        self.record(blocks)            # hits/installs are sightings too


class PinRangePolicy(EvictionPolicy):
    """Pin the block range [lo, hi): pinned blocks are always admitted and
    never evicted (hot-prefix residency — headers, dictionaries, the first
    chromosome); everything else is managed by `inner` (default LRU)."""

    def __init__(self, lo: int, hi: int,
                 inner: Optional[EvictionPolicy] = None):
        if lo > hi:
            raise ValueError(f"inverted pin range [{lo}, {hi})")
        self.lo, self.hi = int(lo), int(hi)
        self.inner = inner or LRUPolicy()
        self.name = f"pin[{lo},{hi})+{self.inner.name}"

    def bind(self, cache: "BlockCache") -> None:
        super().bind(cache)
        self.inner.bind(cache)

    def _pinned(self, blocks: np.ndarray) -> np.ndarray:
        return (blocks >= self.lo) & (blocks < self.hi)

    def admit(self, miss_blocks: np.ndarray) -> np.ndarray:
        return self._pinned(miss_blocks) | self.inner.admit(miss_blocks)

    def victims(self, k: int, evictable: np.ndarray) -> np.ndarray:
        evictable = evictable & ~self._pinned(self.cache.slot_block)
        if not evictable.any():
            return np.zeros(0, np.int64)
        return self.inner.victims(k, evictable)

    def touch(self, slots: np.ndarray, blocks: np.ndarray) -> None:
        self.inner.touch(slots, blocks)


_POLICIES = {"lru": LRUPolicy, "freq": FrequencyPolicy,
             "tinylfu": TinyLFUPolicy}


def make_policy(policy: Union[str, EvictionPolicy]) -> EvictionPolicy:
    if isinstance(policy, EvictionPolicy):
        return policy
    try:
        return _POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown cache policy {policy!r} (have {sorted(_POLICIES)}, "
            f"or pass an EvictionPolicy instance)") from None


# ------------------------------------------------------------------- cache
class BlockCache:
    """Preallocated (capacity, block_size) u8 device buffer + host
    block-id → slot map, with pluggable eviction/admission.

    `plan(uniq)` is the CachePlan step: vectorized hit/miss split + slot
    assignment (mutating the maps and policy state); `realize(plan,
    decode)` turns it into bytes — at most one decode call (the
    pow2-padded miss set) and one install/gather on the device.
    """

    def __init__(self, capacity: int, block_size: int, n_blocks: int,
                 policy: Union[str, EvictionPolicy] = "lru",
                 block_rounds: Optional[np.ndarray] = None,
                 device="cuda"):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.block_size = int(block_size)
        self.n_blocks = int(n_blocks)
        self.block_rounds = block_rounds  # i32[n_blocks] scheduled resolve
                                          # rounds (None = legacy archive)
        self.device = torch.device(device)
        self.buf = self._zeros(self.capacity)
        self.slot_block = np.full(self.capacity, -1, np.int64)
        self.slot_of = np.full(self.n_blocks, -1, np.int32)
        self.policy = make_policy(policy)
        self.policy.bind(self)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.installs = 0
        self.coinstalls = 0
        self.decode_launches = 0

    def _zeros(self, n: int) -> torch.Tensor:
        return torch.zeros((n, self.block_size), dtype=torch.uint8,
                           device=self.device)

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.int64)).to(
            self.device)

    # --------------------------------------------------------------- stats
    @property
    def resident(self) -> int:
        return int((self.slot_block >= 0).sum())

    @property
    def bytes_resident(self) -> int:
        return self.resident * self.block_size

    def info(self) -> dict:
        return {"capacity": self.capacity, "resident": self.resident,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "installs": self.installs,
                "coinstalls": self.coinstalls,
                "bytes_resident": self.bytes_resident,
                "buffer_bytes": self.capacity * self.block_size,
                "decode_launches": self.decode_launches,
                "policy": self.policy.name}

    # ---------------------------------------------------------------- plan
    def plan(self, uniq: np.ndarray) -> CachePlan:
        """Unique covering set → CachePlan. Mutates the slot maps (evicted
        blocks leave, admitted misses claim their slots) and the policy's
        recency/frequency state; the device buffer itself only changes in
        `realize`."""
        uniq = np.asarray(uniq, np.int64).reshape(-1)
        hit_mask, slots = split_cache_hits(uniq, self.slot_of)
        hit_slots = slots[hit_mask]
        miss_blocks = uniq[~hit_mask]
        self.hits += int(hit_mask.sum())
        self.misses += int(miss_blocks.size)
        self.policy.touch(hit_slots, uniq[hit_mask])

        # slot assignment for admitted misses: free slots first, then
        # policy-chosen victims — never a slot this request reads
        admit = (self.policy.admit(miss_blocks) if miss_blocks.size
                 else np.zeros(0, bool))
        free = np.flatnonzero(self.slot_block < 0)
        need = int(admit.sum()) - free.size
        evicted = np.zeros(0, np.int64)
        if need > 0:
            evictable = np.ones(self.capacity, bool)
            evictable[free] = False
            evictable[hit_slots] = False
            evicted = np.asarray(self.policy.victims(need, evictable),
                                 np.int64)
        avail = np.concatenate([free, evicted])
        if avail.size < int(admit.sum()):
            # capacity exhausted (hits + pins occupy everything): trailing
            # admitted misses decode for this request but do not install
            drop = np.flatnonzero(admit)[avail.size:]
            admit[drop] = False
        if evicted.size:
            self.slot_of[self.slot_block[evicted]] = -1
            self.slot_block[evicted] = -1
            self.evictions += int(evicted.size)

        install_slots = np.full(miss_blocks.size, self.capacity, np.int32)
        take = np.flatnonzero(admit)
        install_slots[take] = avail[:take.size]
        if take.size:
            self.slot_block[install_slots[take]] = miss_blocks[take]
            self.slot_of[miss_blocks[take]] = install_slots[take]
            self.installs += int(take.size)
            self.policy.touch(install_slots[take], miss_blocks[take])

        # row sources: hits read their slot, misses read their decode row
        src_is_miss = ~hit_mask
        src_idx = np.empty(uniq.size, np.int32)
        src_idx[hit_mask] = hit_slots
        src_idx[~hit_mask] = np.arange(miss_blocks.size, dtype=np.int32)
        miss_groups = None
        if self.block_rounds is not None and miss_blocks.size:
            r = self.block_rounds[miss_blocks]
            miss_groups = [(int(v), np.flatnonzero(r == v))
                           for v in np.unique(r)]
        return CachePlan(
            uniq=uniq, src_is_miss=src_is_miss, src_idx=src_idx,
            miss_blocks=miss_blocks, install_slots=install_slots,
            n_hits=int(hit_mask.sum()), n_misses=int(miss_blocks.size),
            n_installed=int(take.size), n_evicted=int(evicted.size),
            miss_groups=miss_groups)

    def reset(self) -> None:
        """Drop every resident block and reallocate the buffer (counters
        survive). Also the failure path: `realize` resets on any decode /
        install error, because `plan` has already registered the miss
        blocks as resident — serving stale rows for them later would
        break bit-perfectness silently."""
        self.buf = self._zeros(self.capacity)
        self.slot_block.fill(-1)
        self.slot_of.fill(-1)
        self.policy.bind(self)

    # ------------------------------------------------------------- realize
    def realize(self, cp: CachePlan,
                decode: Callable[[np.ndarray], torch.Tensor]) -> torch.Tensor:
        """CachePlan → (U, block_size) u8 device rows. All-hit plans are
        one buffer gather; otherwise the miss set decodes in ONE
        pow2-padded decode call, the admitted rows install into the buffer
        in place, and hits and misses gather into the output."""
        U = cp.n_uniq
        if U == 0:
            return self._zeros(0)
        if cp.miss_blocks.size == 0:
            return self.buf.index_select(0, self._dev(cp.src_idx))
        try:
            miss_rows = decode(_pad_pow2(cp.miss_blocks))
            self.decode_launches += 1
            inst = np.flatnonzero(cp.install_slots < self.capacity)
            if inst.size:
                self.buf.index_copy_(
                    0, self._dev(cp.install_slots[inst]),
                    miss_rows.index_select(0, self._dev(inst)))
            rows = self._zeros(U)
            hit = np.flatnonzero(~cp.src_is_miss)
            miss = np.flatnonzero(cp.src_is_miss)
            if hit.size:
                rows.index_copy_(0, self._dev(hit), self.buf.index_select(
                    0, self._dev(cp.src_idx[hit])))
            rows.index_copy_(0, self._dev(miss), miss_rows.index_select(
                0, self._dev(cp.src_idx[miss])))
        except BaseException:
            # plan() already marked the misses resident — drop everything
            # rather than serve rows that were never installed as hits
            self.reset()
            raise
        return rows

    def rows_for(self, uniq: np.ndarray,
                 decode: Callable[[np.ndarray], torch.Tensor]
                 ) -> torch.Tensor:
        """plan + realize in one call (the store's `_rows_for_blocks`)."""
        return self.realize(self.plan(uniq), decode)

    def invalidate(self, blocks: np.ndarray) -> int:
        """Evict `blocks` from the slot maps without touching the buffer
        (their slots free; stale rows are unreachable once unmapped).

        The quarantine path: `plan()` registers misses as resident BEFORE
        the decode runs, so when a verified decode reports corrupt blocks
        (`Decoder.last_bad_blocks`) their zeroed rows are already
        installed — the store invalidates them right after `realize` so
        they are never served as hits. Invalidations count as evictions,
        as in the reference. Returns the number evicted."""
        blocks = np.unique(np.asarray(blocks, np.int64).reshape(-1))
        blocks = blocks[(blocks >= 0) & (blocks < self.n_blocks)]
        slots = self.slot_of[blocks]
        live = slots >= 0
        if not live.any():
            return 0
        self.slot_block[slots[live]] = -1
        self.slot_of[blocks[live]] = -1
        self.evictions += int(live.sum())
        return int(live.sum())

    # ---------------------------------------------------------- co-install
    def install_extras(self, blocks: np.ndarray, rows: torch.Tensor) -> int:
        """Install co-decoded rows into FREE slots only.

        An anchored-global miss decodes its whole [anchor, last] window
        but a CachePlan installs only the missed blocks; handing the full
        window here turns a sequential window scan into one decode.
        Speculative rows never evict and leave the policy's state
        untouched, so under pressure they are the first victims. Returns
        the number installed."""
        blocks = np.asarray(blocks, np.int64).reshape(-1)
        fresh = np.flatnonzero(self.slot_of[blocks] < 0)
        free = np.flatnonzero(self.slot_block < 0)
        take = fresh[:free.size]
        if take.size == 0:
            return 0
        slots = free[:take.size]
        try:
            self.buf.index_copy_(0, self._dev(slots),
                                 rows.index_select(0, self._dev(take)))
        except BaseException:
            self.reset()
            raise
        self.slot_block[slots] = blocks[take]
        self.slot_of[blocks[take]] = slots
        self.coinstalls += int(take.size)
        return int(take.size)


class ShardedBlockCache:
    """Per-shard caches over a mesh-partitioned archive: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise _not_in_slice("ShardedBlockCache", "multi-GPU residency")
