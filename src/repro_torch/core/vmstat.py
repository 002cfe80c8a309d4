"""Observability counters for the placement mechanism (paper §5.5).

The paper exposes demotion/promotion statistics via ``/proc/vmstat`` to
debug placement in production.  We mirror that: a flat counter object that
every policy mutates, dumpable as a dict, and comparable across policies.

Counter names follow the upstream kernel patches where one exists
(``pgdemote_kswapd``, ``pgpromote_success``, ...) and the paper's described
counters otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.types import DemoteFail, PromoteFail


@dataclasses.dataclass
class VmStat:
    """Placement event counters.  All counts are cumulative pages."""

    # -- demotion (§5.1) --------------------------------------------------
    pgdemote_anon: int = 0
    pgdemote_file: int = 0
    pgdemote_fail_slow_full: int = 0
    pgdemote_fail_budget: int = 0
    pgdemote_fail_pinned: int = 0
    # Fallback reclaim when the slow tier is full (the paper falls back to
    # swap; we evict-with-recompute for KV pages).
    pswpout: int = 0

    # -- promotion (§5.3) -------------------------------------------------
    pgpromote_sampled: int = 0  # slow-tier hint faults observed
    pgpromote_candidate: int = 0  # passed the active-LRU filter
    pgpromote_success_anon: int = 0
    pgpromote_success_file: int = 0
    pgpromote_fail_low_mem: int = 0
    pgpromote_fail_not_active: int = 0  # filtered (hysteresis)
    pgpromote_fail_budget: int = 0
    pgpromote_fail_pinned: int = 0
    # Denied by the multi-tenant QoS arbiter (quota cap / token bucket).
    pgpromote_fail_qos: int = 0
    # Ping-pong detector: promotion candidates that carry PG_demoted (§5.5).
    pgpromote_candidate_demoted: int = 0

    # -- allocation (§5.2) ------------------------------------------------
    pgalloc_fast: int = 0
    pgalloc_slow: int = 0  # overflow or type-aware slow-first allocations
    pgalloc_stall: int = 0  # allocations that found fast below wm_alloc
    # Allocations whose tier preference was changed by the tiering
    # control plane (e.g. an over-quota tenant steered slow-first).
    pgalloc_steered: int = 0
    pgfree: int = 0

    # -- LRU churn ---------------------------------------------------------
    pgactivate: int = 0
    pgdeactivate: int = 0
    pgscan: int = 0  # reclaim-scan visits

    # -- access accounting (drives the Fig. 14 'local traffic' metric) ----
    access_fast: int = 0
    access_slow: int = 0

    def demote_success(self, is_anon: bool, n: int = 1) -> None:
        if is_anon:
            self.pgdemote_anon += n
        else:
            self.pgdemote_file += n

    def demote_fail(self, reason: DemoteFail, n: int = 1) -> None:
        if reason == DemoteFail.SLOW_FULL:
            self.pgdemote_fail_slow_full += n
        elif reason == DemoteFail.BUDGET:
            self.pgdemote_fail_budget += n
        elif reason == DemoteFail.PINNED:
            self.pgdemote_fail_pinned += n

    def promote_success(self, is_anon: bool, n: int = 1) -> None:
        if is_anon:
            self.pgpromote_success_anon += n
        else:
            self.pgpromote_success_file += n

    def promote_fail(self, reason: PromoteFail, n: int = 1) -> None:
        if reason == PromoteFail.TARGET_LOW_MEM:
            self.pgpromote_fail_low_mem += n
        elif reason == PromoteFail.NOT_ACTIVE:
            self.pgpromote_fail_not_active += n
        elif reason == PromoteFail.BUDGET:
            self.pgpromote_fail_budget += n
        elif reason == PromoteFail.PINNED:
            self.pgpromote_fail_pinned += n
        elif reason == PromoteFail.QOS:
            self.pgpromote_fail_qos += n

    # -- derived metrics ----------------------------------------------------
    @property
    def pgdemote_total(self) -> int:
        return self.pgdemote_anon + self.pgdemote_file

    @property
    def pgpromote_total(self) -> int:
        return self.pgpromote_success_anon + self.pgpromote_success_file

    @property
    def local_access_fraction(self) -> float:
        """Fraction of memory traffic served from the fast tier (Fig. 14)."""
        total = self.access_fast + self.access_slow
        return self.access_fast / total if total else 1.0

    @property
    def promote_success_rate(self) -> float:
        att = self.pgpromote_candidate
        return self.pgpromote_total / att if att else 0.0

    @property
    def ping_pong_rate(self) -> float:
        """Fraction of promotion candidates that were previously demoted."""
        att = self.pgpromote_candidate
        return self.pgpromote_candidate_demoted / att if att else 0.0

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["pgdemote_total"] = self.pgdemote_total
        d["pgpromote_total"] = self.pgpromote_total
        d["local_access_fraction"] = self.local_access_fraction
        d["promote_success_rate"] = self.promote_success_rate
        d["ping_pong_rate"] = self.ping_pong_rate
        return d

    def pretty(self) -> str:
        return "\n".join(f"{k} {v}" for k, v in self.as_dict().items())
