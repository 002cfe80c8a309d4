"""Vectorized per-tenant residency / hotness / migration accounting.

:class:`TenantAccounting` is the telemetry half of the QoS subsystem: a
struct-of-arrays ledger indexed by tenant id, implemented as a
:class:`~repro_torch.core.control.TieringControl` so either page pool keeps it
in sync through the uniform ``pool.control`` lifecycle events
(DESIGN.md §8).  It tracks, per tenant:

* **residency** — live fast-tier / slow-tier page counts (updated on
  alloc/free/demote/promote notes, so reads are O(1) with no pool scan);
* **hotness** — an EWMA of per-interval access counts (the cheap
  NeoMem-style estimate the dynamic quota mode divides headroom by),
  plus the per-interval fast/slow access split the slowdown controller
  measures per-tenant slowdown from;
* **migrations** — promote/demote counts, both cumulative (for the
  ``SimResult.per_tenant`` attribution) and per-interval.

Tenant attribution is a pid-indexed array (``-1`` = untracked); pids are
monotonically increasing in both pools, so a freed pid is never reused
and the slot is simply cleared.  All notes are either O(1) scalar
updates (the reference pool's per-page paths) or one ``bincount`` (the
vectorized pool's batch paths) — both produce identical counter states,
which is what keeps the two engines bit-identical under QoS.

A bare ``TenantAccounting`` keeps every *decision point* neutral
(default allocation steering, victims unreordered, every promotion
admitted): attaching it adds telemetry without changing placement.
:class:`~repro_torch.qos.arbiter.QosArbiter` overrides the decisions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.core.control import TieringControl

_FAST = 0  # Tier.FAST — plain int for the scalar hot paths


class TenantAccounting(TieringControl):
    """Per-tenant SoA ledger + neutral decision surface (``pool.control``)."""

    INITIAL_PID_CAPACITY = 1024

    def __init__(self, n_tenants: int = 1, ewma_alpha: float = 0.3) -> None:
        self.n_tenants = max(1, int(n_tenants))
        self.ewma_alpha = float(ewma_alpha)
        self._tenant_of_pid = np.full(self.INITIAL_PID_CAPACITY, -1, np.int64)
        n = self.n_tenants
        # residency (live pages per tier)
        self.fast_pages = np.zeros(n, np.int64)
        self.slow_pages = np.zeros(n, np.int64)
        # migrations
        self.promoted_total = np.zeros(n, np.int64)
        self.demoted_total = np.zeros(n, np.int64)
        self.promoted_interval = np.zeros(n, np.int64)
        self.demoted_interval = np.zeros(n, np.int64)
        # hotness (total + tier split; the split feeds the slowdown
        # controller's per-tenant measured-slowdown estimate)
        self.access_interval = np.zeros(n, np.int64)
        self.access_fast_interval = np.zeros(n, np.int64)
        self.access_slow_interval = np.zeros(n, np.int64)
        # Cumulative tier-split access totals (never reset): the fleet
        # coordinator snapshots these between ticks, so its measurement
        # window is independent of the interval cadence.
        self.access_fast_total = np.zeros(n, np.int64)
        self.access_slow_total = np.zeros(n, np.int64)
        self.hot_ewma = np.zeros(n, np.float64)
        self.intervals = 0

    # ---------------------------------------------------------------- #
    # capacity
    # ---------------------------------------------------------------- #
    def _ensure_pid_capacity(self, max_pid: int) -> None:
        cap = len(self._tenant_of_pid)
        if max_pid < cap:
            return
        new_cap = max(max_pid + 1, 2 * cap)
        grown = np.full(new_cap, -1, np.int64)
        grown[:cap] = self._tenant_of_pid
        self._tenant_of_pid = grown

    def configure_tenant(self, tenant: int, qos_class: str) -> None:
        """Telemetry keeps no classes — just make room for the tenant."""
        self.ensure_tenants(tenant + 1)

    def ensure_tenants(self, n: int) -> None:
        """Grow every per-tenant array to hold at least ``n`` tenants."""
        if n <= self.n_tenants:
            return
        pad = n - self.n_tenants
        for name in ("fast_pages", "slow_pages", "promoted_total",
                     "demoted_total", "promoted_interval", "demoted_interval",
                     "access_interval", "access_fast_interval",
                     "access_slow_interval", "access_fast_total",
                     "access_slow_total"):
            setattr(self, name, np.concatenate(
                [getattr(self, name), np.zeros(pad, np.int64)]))
        self.hot_ewma = np.concatenate(
            [self.hot_ewma, np.zeros(pad, np.float64)])
        self.n_tenants = n

    # ---------------------------------------------------------------- #
    # tenant attribution
    # ---------------------------------------------------------------- #
    def tenant_of_page(self, pid: int) -> int:
        """Tenant id of a tracked page (−1 = untracked)."""
        if 0 <= pid < len(self._tenant_of_pid):
            return int(self._tenant_of_pid[pid])
        return -1

    def _tenants_of(self, pids: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`tenant_of_page` (−1 for out-of-range)."""
        out = np.full(len(pids), -1, np.int64)
        in_range = (pids >= 0) & (pids < len(self._tenant_of_pid))
        out[in_range] = self._tenant_of_pid[pids[in_range]]
        return out

    # ---------------------------------------------------------------- #
    # pool lifecycle notes (the TieringControl surface)
    # ---------------------------------------------------------------- #
    def note_alloc(self, pid: int, tenant: int, tier: int) -> None:
        """Scalar allocation note (the reference pool's path)."""
        if tenant < 0:
            return
        self._ensure_pid_capacity(pid)
        self._tenant_of_pid[pid] = tenant
        if int(tier) == _FAST:
            self.fast_pages[tenant] += 1
        else:
            self.slow_pages[tenant] += 1

    def note_alloc_many(
        self,
        pids: np.ndarray,
        tenants: Union[int, np.ndarray],
        tiers: np.ndarray,
    ) -> None:
        """Batch allocation note (the vectorized pool's path).

        ``tenants`` is a scalar tenant id or a per-pid array; ``tiers``
        is the per-pid tier array ``try_allocate_many`` placed.
        """
        pids = np.asarray(pids, np.int64)
        if pids.size == 0:
            return
        t = np.broadcast_to(np.asarray(tenants, np.int64), pids.shape)
        tracked = t >= 0
        if not tracked.any():
            return
        pids, t = pids[tracked], t[tracked]
        tiers = np.asarray(tiers)[tracked]
        self._ensure_pid_capacity(int(pids.max()))
        self._tenant_of_pid[pids] = t
        fast = tiers == _FAST
        if fast.any():
            self.fast_pages += np.bincount(t[fast], minlength=self.n_tenants)
        if not fast.all():
            self.slow_pages += np.bincount(t[~fast], minlength=self.n_tenants)

    def note_free(self, pid: int, tier: int) -> None:
        t = self.tenant_of_page(pid)
        if t < 0:
            return
        self._tenant_of_pid[pid] = -1
        if int(tier) == _FAST:
            self.fast_pages[t] -= 1
        else:
            self.slow_pages[t] -= 1

    def note_demote(self, pid: int) -> None:
        t = self.tenant_of_page(pid)
        if t < 0:
            return
        self.fast_pages[t] -= 1
        self.slow_pages[t] += 1
        self.demoted_total[t] += 1
        self.demoted_interval[t] += 1

    def note_promote(self, pid: int) -> None:
        t = self.tenant_of_page(pid)
        if t < 0:
            return
        self.slow_pages[t] -= 1
        self.fast_pages[t] += 1
        self.promoted_total[t] += 1
        self.promoted_interval[t] += 1

    def note_demote_many(self, pids: np.ndarray) -> None:
        """Batched :meth:`note_demote` (the vectorized demotion batch)."""
        counts = self._migration_counts(pids)
        if counts is None:
            return
        self.fast_pages -= counts
        self.slow_pages += counts
        self.demoted_total += counts
        self.demoted_interval += counts

    def note_promote_many(self, pids: np.ndarray) -> None:
        """Batched :meth:`note_promote` (the vectorized promotion batch)."""
        counts = self._migration_counts(pids)
        if counts is None:
            return
        self.slow_pages -= counts
        self.fast_pages += counts
        self.promoted_total += counts
        self.promoted_interval += counts

    def _migration_counts(self, pids: np.ndarray) -> Optional[np.ndarray]:
        pids = np.asarray(pids, np.int64)
        if pids.size == 0:
            return None
        t = self._tenants_of(pids)
        t = t[t >= 0]
        if t.size == 0:
            return None
        return np.bincount(t, minlength=self.n_tenants)

    # ---------------------------------------------------------------- #
    # access telemetry
    # ---------------------------------------------------------------- #
    def note_access_tiers(
        self, fast_counts: np.ndarray, slow_counts: np.ndarray
    ) -> None:
        """Fold one step's per-tenant access counts (split by tier)."""
        self.access_fast_interval += fast_counts
        self.access_slow_interval += slow_counts
        self.access_fast_total += fast_counts
        self.access_slow_total += slow_counts
        self.access_interval += fast_counts
        self.access_interval += slow_counts

    def note_hits(self, fast_pids: np.ndarray, slow_pids: np.ndarray) -> None:
        """Attribute a step's touched pids to tenants (serving path)."""
        fast = self._migration_counts(fast_pids)
        slow = self._migration_counts(slow_pids)
        zeros = None
        if fast is None or slow is None:
            zeros = np.zeros(self.n_tenants, np.int64)
        if fast is not None or slow is not None:
            self.note_access_tiers(
                fast if fast is not None else zeros,
                slow if slow is not None else zeros,
            )

    def note_interval(self) -> None:
        """Close an interval: fold access counts into the hotness EWMA."""
        a = self.ewma_alpha
        self.hot_ewma = (1.0 - a) * self.hot_ewma + a * self.access_interval
        self.access_interval[:] = 0
        self.access_fast_interval[:] = 0
        self.access_slow_interval[:] = 0
        self.promoted_interval[:] = 0
        self.demoted_interval[:] = 0
        self.intervals += 1

    # ---------------------------------------------------------------- #
    # introspection
    # ---------------------------------------------------------------- #
    def fleet_telemetry(self) -> Dict[str, np.ndarray]:
        """Cumulative per-tenant counters for a fleet-coordinator tick.

        Every array is a copy (safe to snapshot and diff across ticks);
        subclasses extend with their arbitration counters.
        """
        return {
            "access_fast": self.access_fast_total.copy(),
            "access_slow": self.access_slow_total.copy(),
            "promoted": self.promoted_total.copy(),
            "demoted": self.demoted_total.copy(),
            "fast_pages": self.fast_pages.copy(),
            "slow_pages": self.slow_pages.copy(),
        }

    def residency(self) -> Dict[int, Dict[str, int]]:
        return {
            t: {"fast": int(self.fast_pages[t]), "slow": int(self.slow_pages[t])}
            for t in range(self.n_tenants)
        }

    def check_consistency(self, pool) -> None:
        """Assert the ledger matches the pool's live page table (tests)."""
        from repro_torch.core.types import Tier  # local: keep import surface tiny

        fast = np.zeros(self.n_tenants, np.int64)
        slow = np.zeros(self.n_tenants, np.int64)
        for tier, acc in ((Tier.FAST, fast), (Tier.SLOW, slow)):
            for pid in pool.pages_in_tier(tier):
                t = self.tenant_of_page(pid)
                if t >= 0:
                    acc[t] += 1
        assert np.array_equal(fast, self.fast_pages), (
            f"fast residency drift: ledger {self.fast_pages} vs pool {fast}"
        )
        assert np.array_equal(slow, self.slow_pages), (
            f"slow residency drift: ledger {self.slow_pages} vs pool {slow}"
        )
