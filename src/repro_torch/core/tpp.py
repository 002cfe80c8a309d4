"""TPP — the paper's transparent page placement policy (§5).

Drives any :class:`~repro_torch.core.policy.PlacementPool` (the reference
``PagePool`` or the vectorized ``VectorPagePool``) with the four
mechanisms:

1. **Lightweight demotion** (§5.1): reclaim candidates are taken from the
   fast tier's *inactive* LRU tails (both anon and file) and *migrated* to
   the slow tier instead of swapped.  On slow-tier-full, fall back to
   eviction (the swap analogue), per page.
2. **Decoupled watermarks** (§5.2): background demotion triggers whenever
   fast-tier free frames drop below ``wm_demote`` (demote_scale_factor)
   and keeps reclaiming until the headroom is restored, *independent of*
   the allocation path, which only needs ``wm_min``.
3. **Promotion with hysteresis** (§5.3): sampled slow-tier accesses
   ("NUMA hint faults", restricted to the slow node) promote a page only
   if it is already on the **active** LRU; a faulted inactive page is
   activated instead and must fault again (Fig. 13).  Promotion ignores
   the allocation watermark.
4. **Page-type-aware allocation** (§5.4): handled by the pool via
   ``TppConfig.file_to_slow``.

The policy implements the uniform
:class:`~repro_torch.core.policy.PlacementPolicy` protocol: :meth:`step` is fed
the slow- and fast-tier page hits observed by the data plane this step
(TPP ignores the fast hits — the paper never samples the local node).
It is a host-side control loop — the same role the kernel's
kswapd/NUMA-balancing tasks play — while the actual payload copies happen
in the engine (``on_migrate`` hook of the pool).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

from repro_torch.core.policy import (
    PlacementPool,
    StepReport,
    make_policy,  # noqa: F401  (re-exported for backward compatibility)
    register_policy,
)
from repro_torch.core.types import (
    PromoteFail,
    Tier,
    TppConfig,
)

__all__ = ["TppPolicy", "StepReport", "make_policy"]


@register_policy
class TppPolicy:
    """The full TPP mechanism."""

    name = "tpp"

    def __init__(self, pool: PlacementPool, seed: int = 0) -> None:
        self.pool = pool
        self.config: TppConfig = pool.config
        self._rng = np.random.default_rng(seed)

    # ------------------------------------------------------------------ #
    # promotion path (§5.3)
    # ------------------------------------------------------------------ #
    def _sample_hint_faults(self, slow_hits: Sequence[int]) -> Sequence[int]:
        """NUMA-hint-fault sampling, restricted to the slow tier.

        The paper limits NUMA Balancing's sampling to CXL nodes only; the
        fast tier is never sampled (no wasted faults on local memory).
        The keep-mask is drawn in one vectorized call so sampling cost
        does not scale with per-page Python work.
        """
        rate = self.config.sample_rate
        if rate >= 1.0 or len(slow_hits) == 0:
            return slow_hits
        keep = self._rng.random(len(slow_hits)) < rate
        return [pid for pid, k in zip(slow_hits, keep) if k]

    def _promote(self, candidates: Iterable[int], report: StepReport) -> None:
        """Promotion control loop, batched without changing semantics.

        Candidates that clear every gate are queued and applied through
        ``pool.promote_pages`` (one batched admission + migration call —
        the fleet-scale fix for the former per-pid ``promote_page``
        loop).  The queue flushes whenever deferral could change a later
        decision — a re-hit on a queued page, the budget verdict, or the
        fast tier running out of headroom — so the VmStat trajectory and
        every placement decision are bit-identical to the sequential
        per-pid loop (``tests/test_control.py`` pins this).
        """
        pool = self.pool
        budget = self.config.promote_budget
        # The coupled ablation gates each promotion on the *current*
        # watermark, which every success moves — keep it per-pid.
        defer = self.config.decoupled
        pending: List[int] = []
        pending_set: set = set()

        def flush() -> None:
            if not pending:
                return
            n_ok, n_failed = pool.promote_pages(pending)
            report.promoted += n_ok
            report.promote_failed += n_failed
            pending.clear()
            pending_set.clear()

        for pid in candidates:
            if pid in pending_set:
                # re-hit on a queued page: settle the queue so the
                # liveness/tier checks below see the promoted state
                flush()
            if not pool.is_slow_live(pid):
                continue  # freed or already migrated this step
            pool.vmstat.pgpromote_sampled += 1

            if self.config.active_lru_filter and not pool.is_active(pid):
                # Fig. 13 step ②: activate instead of promoting; the page
                # must still be hot at its *next* fault to be promoted.
                pool.vmstat.promote_fail(PromoteFail.NOT_ACTIVE)
                report.promote_filtered += 1
                pool.activate(pid)
                continue

            pool.vmstat.pgpromote_candidate += 1
            if pool.is_demoted(pid):
                pool.vmstat.pgpromote_candidate_demoted += 1

            if report.promoted + len(pending) >= budget:
                flush()  # settle actual successes before the verdict
            if report.promoted >= budget:
                pool.vmstat.promote_fail(PromoteFail.BUDGET)
                report.promote_failed += 1
                continue

            if self.config.decoupled:
                # Promotion ignores wm_alloc (§5.3) but does need a frame.
                # Demotion is *continuous* (kswapd keeps reclaiming while
                # promotions land), so promotion pressure below the
                # headroom triggers more background demotion within the
                # same interval — not a one-shot snapshot.
                if pool.free_frames(Tier.FAST) - len(pending) <= 0:
                    flush()
                    if (pool.free_frames(Tier.FAST) == 0
                            and report.demoted < self.config.demote_budget):
                        self._demote(report)
            elif pool.under_alloc_watermark():
                # Coupled ablation (Fig. 17): reclaim serves allocation
                # only; promotion is watermark-gated and starves under
                # pressure — the paper's "promotion almost halts".
                pool.vmstat.promote_fail(PromoteFail.TARGET_LOW_MEM)
                report.promote_failed += 1
                continue
            if defer:
                pending.append(pid)
                pending_set.add(pid)
            else:
                res = pool.promote_page(pid)
                if res == PromoteFail.NONE:
                    report.promoted += 1
                else:
                    report.promote_failed += 1
        flush()

    # ------------------------------------------------------------------ #
    # demotion path (§5.1 + §5.2)
    # ------------------------------------------------------------------ #
    def _demote(self, report: StepReport) -> None:
        pool = self.pool
        if self.config.decoupled:
            need = pool.wm_demote - pool.free_frames(Tier.FAST)
        else:
            # Coupled ablation (Fig. 17): reclaim only reacts to the
            # allocation watermark, with no extra headroom.
            need = pool.wm_alloc - pool.free_frames(Tier.FAST)
        if need <= 0:
            return
        nr = min(need, self.config.demote_budget - report.demoted)
        if nr <= 0:
            return
        # Age the active lists first so the inactive tails reflect recency.
        pool.age_active(Tier.FAST)
        candidates = pool.scan_reclaim_candidates(Tier.FAST, nr)
        n_ok, overflow, n_failed = pool.demote_pages(candidates)
        report.demoted += n_ok
        report.demote_failed += n_failed
        for pid in overflow:
            # §5.1: slow tier full — fall back to default reclamation
            # (the swap analogue) for that page.
            if not pool.is_pinned(pid):
                pool.evict_page(pid)
                report.evicted += 1
            else:
                report.demote_failed += 1

    # ------------------------------------------------------------------ #
    def step(
        self,
        slow_hits: Sequence[int] = (),
        fast_hits: Sequence[int] = (),
    ) -> StepReport:
        """One control-loop iteration.

        ``slow_hits`` / ``fast_hits`` — page ids whose accesses this step
        were served by the slow / fast tier (the engine's block-table
        lookups make these free to collect; see DESIGN.md §2).  TPP
        never samples the fast tier, so ``fast_hits`` is ignored.
        """
        del fast_hits  # TPP restricts hint faults to the slow node (§5.3)
        report = StepReport()
        self._promote(self._sample_hint_faults(slow_hits), report)
        self._demote(report)
        self.pool.step += 1
        return report
