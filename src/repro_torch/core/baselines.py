"""The paper's comparison systems (§6, Table 1), as pluggable policies.

Every baseline implements the :class:`~repro_torch.core.policy.PlacementPolicy`
protocol and drives the *same* pool and data plane as TPP — only the
placement logic differs, mirroring how the paper swaps kernels on
identical hardware.  All policies run unchanged against the reference
``PagePool`` and the vectorized ``VectorPagePool``.

A copy of ``repro.core.baselines`` with the same behaviour; the port
keeps its own so that it imports nothing of ``repro``.

* ``DefaultLinuxPolicy`` — unmodified Linux on a tiered system: local-first
  allocation with overflow to the CXL node, **no migration in either
  direction** (reclaim would swap to disk; the paper's experiments disable
  swap and never hit it).  Pages stay where first placed.
* ``NumaBalancingPolicy`` — upstream AutoNUMA (§2, §6.3.1): samples pages
  on *all* nodes (wasted fast-tier faults = CPU overhead), promotes
  instantly on fault with **no hysteresis**, but refuses to promote when
  the fast tier is below the allocation watermark (it has no demotion to
  make headroom, so under pressure promotion "effectively stops").
* ``AutoTieringPolicy`` — [Kim et al., ATC'21] (§6.3.1): frequency-based
  demotion (lowest access-count victims, not LRU), prompt promotion of
  pages whose access frequency clears a threshold, and a **fixed-size
  reserved buffer** for promotions with a *coupled* allocation/reclamation
  path: the reserve is only refilled by allocation-pressure reclaim, so a
  promotion surge exhausts it and promotions stall (the paper's Fig. 19
  failure mode).
* ``IdealPolicy`` — the paper's baseline: every page in fast memory (the
  harness sizes the fast tier to the workload; asserts no overflow).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.policy import PlacementPool, StepReport, register_policy
from repro_torch.core.types import (
    PromoteFail,
    Tier,
)


@register_policy
class DefaultLinuxPolicy:
    name = "linux"

    def __init__(self, pool: PlacementPool, seed: int = 0) -> None:
        self.pool = pool

    def step(
        self,
        slow_hits: Sequence[int] = (),
        fast_hits: Sequence[int] = (),
    ) -> StepReport:
        # No demotion, no promotion.  LRU aging still happens (the kernel
        # always ages), it just never feeds a migration.
        self.pool.age_active(Tier.FAST)
        self.pool.step += 1
        return StepReport()


@register_policy
class NumaBalancingPolicy:
    name = "numa_balancing"

    def __init__(self, pool: PlacementPool, seed: int = 0) -> None:
        self.pool = pool
        self._rng = np.random.default_rng(seed)
        self.sample_rate = pool.config.sample_rate
        # Extra overhead accounting: AutoNUMA samples the fast tier too.
        self.wasted_fast_faults = 0

    def step(
        self,
        slow_hits: Sequence[int] = (),
        fast_hits: Sequence[int] = (),
    ) -> StepReport:
        pool = self.pool
        report = StepReport()
        # Fast-tier sampling achieves nothing on a two-tier system (there
        # is nowhere better to move a fast page) — pure overhead (§6.3.1:
        # "unnecessary sampling, 2% higher CPU overhead than TPP").
        self.wasted_fast_faults += len(fast_hits)

        if self.sample_rate < 1.0 and len(slow_hits):
            keep = self._rng.random(len(slow_hits)) < self.sample_rate
            slow_hits = [pid for pid, k in zip(slow_hits, keep) if k]
        for pid in slow_hits:
            if not pool.is_slow_live(pid):
                continue
            pool.vmstat.pgpromote_sampled += 1
            pool.vmstat.pgpromote_candidate += 1  # instant: every fault
            if pool.is_demoted(pid):
                pool.vmstat.pgpromote_candidate_demoted += 1
            # Upstream NUMA balancing respects the watermark — with no
            # demotion path there is no headroom, so this is the stall.
            if pool.under_alloc_watermark():
                pool.vmstat.promote_fail(PromoteFail.TARGET_LOW_MEM)
                report.promote_failed += 1
                continue
            res = pool.promote_page(pid)
            if res == PromoteFail.NONE:
                report.promoted += 1
            else:
                report.promote_failed += 1
        pool.age_active(Tier.FAST)
        pool.step += 1
        return report


@register_policy
class AutoTieringPolicy:
    name = "autotiering"

    # Fraction of fast frames kept as the fixed promotion reserve.
    RESERVE_FRACTION = 0.01
    # Access-frequency threshold (touches within the history window) above
    # which a slow page is considered hot enough to promote.
    HOT_FREQ = 2

    def __init__(self, pool: PlacementPool, seed: int = 0) -> None:
        self.pool = pool
        self.reserve = max(1, int(self.RESERVE_FRACTION * pool.num_frames[Tier.FAST]))
        self._reserve_left = self.reserve

    def _demote_for_alloc(self, report: StepReport) -> None:
        """Coupled reclaim: only when allocation pressure demands it."""
        pool = self.pool
        need = pool.wm_alloc - pool.free_frames(Tier.FAST)
        if need <= 0:
            return
        # Frequency-based victim selection: lowest touch_count first.
        victims = pool.demotion_victims(min(need, pool.config.demote_budget))
        n_ok, overflow, n_failed = pool.demote_pages(victims)
        report.demoted += n_ok
        # Coupled path: demotions replenish the promotion reserve.
        self._reserve_left = min(self.reserve, self._reserve_left + n_ok)
        report.demote_failed += len(overflow) + n_failed

    def step(
        self,
        slow_hits: Sequence[int] = (),
        fast_hits: Sequence[int] = (),
    ) -> StepReport:
        pool = self.pool
        report = StepReport()
        for pid in slow_hits:
            if not pool.is_slow_live(pid):
                continue
            pool.vmstat.pgpromote_sampled += 1
            if pool.touch_count_of(pid) < self.HOT_FREQ:
                continue  # timer/frequency filter
            pool.vmstat.pgpromote_candidate += 1
            if pool.is_demoted(pid):
                pool.vmstat.pgpromote_candidate_demoted += 1
            under_pressure = pool.free_frames(Tier.FAST) <= pool.wm_min
            if under_pressure and self._reserve_left <= 0:
                # Reserve exhausted under pressure → promotions stall
                # (the Fig. 19 surge failure; refilled only by coupled
                # allocation-driven reclaim).
                pool.vmstat.promote_fail(PromoteFail.TARGET_LOW_MEM)
                report.promote_failed += 1
                continue
            if pool.free_frames(Tier.FAST) == 0:
                pool.vmstat.promote_fail(PromoteFail.TARGET_LOW_MEM)
                report.promote_failed += 1
                continue
            res = pool.promote_page(pid)
            if res == PromoteFail.NONE:
                if under_pressure:
                    self._reserve_left -= 1
                report.promoted += 1
            else:
                report.promote_failed += 1
        self._demote_for_alloc(report)
        pool.age_active(Tier.FAST)
        pool.step += 1
        return report


@register_policy
class IdealPolicy:
    """All memory in the fast tier (the paper's normalization baseline)."""

    name = "ideal"

    def __init__(self, pool: PlacementPool, seed: int = 0) -> None:
        self.pool = pool
        if pool.num_frames[Tier.SLOW] != 0:
            raise ValueError(
                "IdealPolicy expects a pool with num_slow=0 and num_fast "
                ">= working set (that is the baseline's definition)"
            )

    def step(
        self,
        slow_hits: Sequence[int] = (),
        fast_hits: Sequence[int] = (),
    ) -> StepReport:
        assert not len(slow_hits), "ideal baseline must never see slow hits"
        self.pool.step += 1
        return StepReport()
