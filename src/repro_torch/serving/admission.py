"""Admission control for the multi-tenant serving plane.

Two concerns live here, both feeding `repro_torch.serving.frontend`:

* `TenantPartitionPolicy` — per-tenant BlockCache partitions: every
  tenant is guaranteed a hard floor of slots it can never be thrashed
  out of by cross-tenant traffic, while capacity beyond the floors is a
  shared spill pool any tenant wins and loses on the inner policy's
  merits (default `TinyLFUPolicy`: doorkeeper + aged sketch admission).
  Composes at the same `EvictionPolicy` seam every other policy uses, so
  the cache's vectorized CachePlan step is unchanged.

* `ServiceEstimator` — the EWMA service-time model behind deadline
  feasibility: the frontend observes each dispatch cycle (wall time +
  covering-block count, seeded by `ReadBatcher.stats()["last_flush_us"]`)
  and `submit()` rejects a request with a typed `Overloaded` when the
  projected queue wait already blows its deadline — bounded queues plus
  early rejection instead of silent backlog growth.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

from repro_torch.api.cache import EvictionPolicy, TinyLFUPolicy, make_policy


class TenantPartitionPolicy(EvictionPolicy):
    """Per-tenant cache partitions: hard slot floors + shared spill pool.

    A slot is owned by the tenant whose request last touched it. When
    the current tenant `c` needs victims, a slot owned by tenant `v` is
    evictable only if `v == c` or `v` holds MORE slots than its floor —
    so a tenant's floor-many hottest blocks can never be evicted by
    another tenant's traffic, however adversarial, while the spill pool
    (`capacity - sum(floors)`) stays contested under the inner policy's
    admission/eviction order. The serving frontend calls `set_tenant`
    before each per-tenant dispatch; tenants it never declared get floor
    0 (spill-only). `sum(floors)` above capacity is rejected at bind.
    """

    def __init__(self, floors: Mapping[str, int],
                 inner: Optional[EvictionPolicy] = None):
        self.floors: Dict[str, int] = {}
        for t, f in floors.items():
            if int(f) < 0:
                raise ValueError(f"negative floor {f} for tenant {t!r}")
            self.floors[str(t)] = int(f)
        self.inner = (make_policy(inner) if inner is not None
                      else TinyLFUPolicy())
        self.name = f"tenant+{self.inner.name}"
        self._names = list(self.floors)
        self._idx = {t: i for i, t in enumerate(self._names)}
        self._current = -1

    def bind(self, cache) -> None:
        super().bind(cache)
        total = sum(self.floors.values())
        if total > cache.capacity:
            raise ValueError(
                f"tenant floors sum to {total} slots but cache capacity "
                f"is {cache.capacity}")
        self.inner.bind(cache)
        self.slot_tenant = np.full(cache.capacity, -1, np.int64)

    # ----------------------------------------------------------- tenancy
    def set_tenant(self, tenant: str) -> None:
        """Name the tenant on whose behalf subsequent accesses run."""
        tenant = str(tenant)
        if tenant not in self._idx:
            self._idx[tenant] = len(self._names)
            self._names.append(tenant)
            self.floors.setdefault(tenant, 0)
        self._current = self._idx[tenant]

    def resident_counts(self) -> Dict[str, int]:
        """Resident slots per tenant (floor-guarantee observability)."""
        owned = self.slot_tenant[self.slot_tenant >= 0]
        counts = np.bincount(owned, minlength=len(self._names))
        return {t: int(counts[i]) for i, t in enumerate(self._names)}

    # ------------------------------------------------------ policy hooks
    def admit(self, miss_blocks: np.ndarray) -> np.ndarray:
        return self.inner.admit(miss_blocks)

    def victims(self, k: int, evictable: np.ndarray) -> np.ndarray:
        owner = self.slot_tenant
        floors = np.array([self.floors[t] for t in self._names], np.int64)
        counts = np.bincount(owner[owner >= 0],
                             minlength=len(self._names))[:len(self._names)]
        surplus = counts - floors      # slots each tenant holds over floor
        owned = owner >= 0
        surplus_of = np.where(owned, surplus[np.clip(owner, 0, None)], 0)
        # other tenants' slots at-or-below their floor are untouchable
        allowed = evictable & owned
        allowed &= ~((owner != self._current) & (surplus_of <= 0))
        if not allowed.any():
            return np.zeros(0, np.int64)
        # inner policy ranks the permitted candidates; cap the take per
        # foreign tenant at its surplus so a batch eviction cannot dig a
        # victim tenant below its floor either
        cand = self.inner.victims(int(allowed.sum()), allowed)
        budget = surplus.copy()
        take = []
        for s in cand:
            v = int(owner[s])
            if v == self._current:
                take.append(int(s))
            elif budget[v] > 0:
                take.append(int(s))
                budget[v] -= 1
            if len(take) == k:
                break
        chosen = np.asarray(take, np.int64)
        self.slot_tenant[chosen] = -1   # ownership leaves with the slot
        return chosen

    def touch(self, slots: np.ndarray, blocks: np.ndarray) -> None:
        self.inner.touch(slots, blocks)
        slots = np.asarray(slots, np.int64).reshape(-1)
        if self._current >= 0 and slots.size:
            self.slot_tenant[slots] = self._current


class ServiceEstimator:
    """EWMA model of per-dispatch service time.

    The frontend observes every dispatch cycle: wall time in µs and the
    number of unique covering blocks it decoded/gathered
    (`DecodePlan.n_cover_blocks` units; the `ReadBatcher.stats()`
    `last_flush_us` field is the wall-time source on the batched
    read-id path). `batch_us` answers "what does one scheduler cycle
    cost right now"; submit-time feasibility multiplies it by the number
    of cycles queued ahead of a request. Until the first observation the
    estimator is cold and admission control stays open (nothing to
    project from).
    """

    def __init__(self, alpha: float = 0.25):
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.batch_us = 0.0
        self.per_block_us = 0.0
        self.observations = 0

    @property
    def warm(self) -> bool:
        return self.observations > 0

    def observe(self, batch_us: float, n_blocks: int = 0) -> None:
        batch_us = float(batch_us)
        a = self.alpha
        if self.observations == 0:
            self.batch_us = batch_us
            if n_blocks > 0:
                self.per_block_us = batch_us / n_blocks
        else:
            self.batch_us += a * (batch_us - self.batch_us)
            if n_blocks > 0:
                self.per_block_us += a * (batch_us / n_blocks
                                          - self.per_block_us)
        self.observations += 1

    def projected_wait_us(self, batches_ahead: int) -> float:
        """Queue wait for a request `batches_ahead` scheduler cycles deep
        (including its own cycle). Cold estimator → 0 (admit)."""
        return float(batches_ahead) * self.batch_us

    def info(self) -> dict:
        return {"batch_us": round(self.batch_us, 1),
                "per_block_us": round(self.per_block_us, 2),
                "observations": self.observations}
