"""The QoS arbiter: tenant-aware tiering arbitration for both engines.

:class:`QosArbiter` extends the telemetry ledger
(:class:`~repro_torch.qos.accounting.TenantAccounting`) into a full
:class:`~repro_torch.core.control.TieringControl`: it implements all three
decision points both page pools dispatch through ``pool.control``:

* **allocation steering** (§5.4 generalized) — new pages of an
  over-quota tenant are steered slow-first at allocation time, so a
  churny neighbor stops carving fast-tier headroom out of everyone
  else's quota before demotion even has to run.  Steered placements
  count as ``pgalloc_steered``; the pool still enforces watermarks, so
  steering can never violate them.
* **demotion victim ordering** — reclaim candidates from over-quota
  tenants demote first (a stable partition of the pool's candidate
  list, so the LRU/frequency order within each group is preserved and
  both engines see the same sequence);
* **promotion admission** — batched: one
  :meth:`~QosArbiter.admit_promotions` call admits a whole candidate
  batch, exactly equivalent to asking per-pid in order (intra-batch
  token consumption and provisional residency are modeled closed-form
  per tenant).  A promotion is admitted only while the tenant is under
  its fast-tier quota (+ slack) *and* its token bucket has a token
  (refilled per interval proportionally to priority weight).  Denials
  count as ``pgpromote_fail_qos`` / ``PromoteFail.QOS`` — a
  latency-critical stream can never be starved of migration bandwidth
  by a churny batch neighbor.

Every decision is a pure function of counters that are bit-identical
across the reference and vectorized engines, so placement under QoS is
too (tests/test_qos.py enforces it); with a ``NullControl`` both
engines are bit-identical to the control-free output.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.control import AllocRequest, VictimCandidate
from repro_torch.core.types import Tier
from repro_torch.qos.accounting import TenantAccounting
from repro_torch.qos.quota import (
    QosConfig,
    class_weights,
    dynamic_quotas,
    static_quotas,
    token_refill,
)


class QosArbiter(TenantAccounting):
    """Quota + token-bucket arbitration over the tenant ledger."""

    def __init__(
        self,
        n_tenants: int,
        fast_frames: int,
        config: Optional[QosConfig] = None,
        classes: Optional[Sequence[str]] = None,
    ) -> None:
        self.config = config or QosConfig()
        super().__init__(n_tenants, ewma_alpha=self.config.ewma_alpha)
        self.fast_frames = int(fast_frames)
        cls = list(classes if classes is not None else self.config.classes)
        cls += ["standard"] * (self.n_tenants - len(cls))
        self.classes: List[str] = cls[: self.n_tenants]
        self._rebuild_shares()
        # buckets start full so a fresh tenant can promote immediately
        self.tokens = self._burst.copy()
        # arbitration observability
        self.denied_quota = np.zeros(self.n_tenants, np.int64)
        self.denied_token = np.zeros(self.n_tenants, np.int64)
        self.violations_by_tenant = np.zeros(self.n_tenants, np.int64)
        self.quota_violation_intervals = 0
        # decision timeline: cumulative steer/shed counts plus one
        # per-interval delta record (steered / denied / shed / share
        # vector) so a TierSan report or a parity diff can point at the
        # interval where placement went wrong.
        self.steered_total = 0
        self.shed_total = 0
        self.timeline: List[Dict] = []
        self._tl_prev: Optional[Dict[str, int]] = None
        # serving relief escalation: consecutive pressured relief_action
        # queries (resets the moment pressure clears)
        self._pressure_streak = 0
        self.evictions_recommended = 0

    # ---------------------------------------------------------------- #
    # shares / growth
    # ---------------------------------------------------------------- #
    def _rebuild_shares(self) -> None:
        self.weights = class_weights(self.config, self.classes)
        self.quota = static_quotas(self.config, self.weights, self.fast_frames)
        if self.config.mode == "dynamic" and self.intervals > 0:
            self.quota = dynamic_quotas(
                self.config, self.weights, self.hot_ewma, self.fast_frames
            )
        self._refill = token_refill(self.config, self.weights)
        self._burst = self.config.token_burst * np.maximum(self._refill, 1.0)

    def ensure_tenants(self, n: int) -> None:
        if n <= self.n_tenants:
            return
        pad = n - self.n_tenants
        super().ensure_tenants(n)
        self.classes += ["standard"] * pad
        for name in ("denied_quota", "denied_token", "violations_by_tenant"):
            setattr(self, name, np.concatenate(
                [getattr(self, name), np.zeros(pad, np.int64)]))
        old_tokens = self.tokens
        self._rebuild_shares()
        self.tokens = np.concatenate([old_tokens, self._burst[-pad:]])

    def set_fast_budget(self, budget: int) -> None:
        """Re-divide tenant quotas over a new host fast-tier budget.

        The fleet coordinator pushes a host's share of the global
        fast-tier budget down mid-run; the quota ledger re-divides its
        shares over the new capacity and clips token buckets to the
        rebuilt burst so no tenant keeps promotion credit earned against
        a larger tier.  Residency/migration counters are untouched — a
        budget change never rewrites history, only future admissions.
        """
        if budget < 1:
            raise ValueError(f"fast budget must be >= 1 (got {budget})")
        self.fast_frames = int(budget)
        self._rebuild_shares()
        self.tokens = np.minimum(self.tokens, self._burst)

    def configure_tenant(self, tenant: int, qos_class: str) -> None:
        """Assign (or reassign) a tenant's priority class."""
        if qos_class not in self.config.priority:
            raise ValueError(
                f"unknown qos class {qos_class!r}; choose from "
                f"{sorted(self.config.priority)}"
            )
        self.ensure_tenants(tenant + 1)
        if self.classes[tenant] != qos_class:
            self.classes[tenant] = qos_class
            self._rebuild_shares()
            self.tokens = np.minimum(self.tokens, self._burst)

    # ---------------------------------------------------------------- #
    # decision point: allocation steering (§5.4 tenant-aware)
    # ---------------------------------------------------------------- #
    @property
    def steers_allocation(self) -> bool:  # type: ignore[override]
        return self.config.steer_allocation

    def _over_quota(self, tenant: int) -> bool:
        return bool(
            self.fast_pages[tenant]
            > self.quota[tenant] + self.config.quota_slack
        )

    def steer_allocation(self, req: AllocRequest) -> Tier:
        """Over-quota tenants' new pages go slow-first.

        Caller-forced placements (``prefer``), untracked tenants and
        **pinned** pages keep the pool's default — a pinned page can
        never migrate, so steering it slow would strand it there long
        after the tenant drops back under quota.  The pool's watermark
        machinery still applies to whatever is returned.
        """
        if (req.prefer is None and not req.pinned
                and 0 <= req.tenant < self.n_tenants
                and self._over_quota(req.tenant)):
            if req.default != Tier.SLOW:
                self.steered_total += 1
            return Tier.SLOW
        return req.default

    # ---------------------------------------------------------------- #
    # decision point: demotion victim ordering
    # ---------------------------------------------------------------- #
    def order_demotion_victims(self, pids: List[int]) -> List[int]:
        """Stable partition: pages of over-quota tenants demote first."""
        if len(pids) < 2:
            return pids
        arr = np.asarray(pids, np.int64)
        t = self._tenants_of(arr)
        over = np.zeros(len(arr), bool)
        known = t >= 0
        if known.any():
            slack = self.config.quota_slack
            tk = t[known]
            over[known] = self.fast_pages[tk] > self.quota[tk] + slack
        if not over.any() or over.all():
            return pids
        return [p for p, o in zip(pids, over) if o] + \
               [p for p, o in zip(pids, over) if not o]

    # ---------------------------------------------------------------- #
    # decision point: promotion admission (batched)
    # ---------------------------------------------------------------- #
    def admit_promotions(self, pids: Sequence[int]) -> np.ndarray:
        """Quota + token-bucket gate over a promotion candidate batch.

        Exactly equivalent to admitting per pid in order under the
        assumption that every admitted candidate's migration succeeds
        (the pools' batch path guarantees a free fast frame per
        candidate before calling).  Within the batch each admission
        provisionally raises its tenant's residency and consumes a
        token, so the per-tenant admitted count is the closed form
        ``min(candidates, quota room, floor(tokens))`` — whole-integer
        token subtraction is exact in float64, keeping the result
        bit-identical to the scalar sequence.
        """
        n = len(pids)
        if n == 1:
            return np.asarray([self._admit_one(int(pids[0]))])
        arr = np.asarray(pids, np.int64)
        tenants = self._tenants_of(arr)
        mask = np.ones(n, bool)
        slack = self.config.quota_slack
        for t in np.unique(tenants):
            t = int(t)
            if t < 0:
                continue  # untracked pages are outside arbitration
            idx = np.flatnonzero(tenants == t)
            n_t = len(idx)
            room = float(self.quota[t]) + slack - float(self.fast_pages[t])
            q_admits = max(0, math.ceil(room))
            tok = float(self.tokens[t])
            t_admits = int(tok) if tok >= 1.0 else 0
            admits = min(n_t, q_admits, t_admits)
            if admits < n_t:
                # all remaining denials fail the same (first) check the
                # scalar sequence would: quota before tokens
                if q_admits <= admits:
                    self.denied_quota[t] += n_t - admits
                else:
                    self.denied_token[t] += n_t - admits
                mask[idx[admits:]] = False
            if admits:
                self.tokens[t] -= float(admits)
        return mask

    def _admit_one(self, pid: int) -> bool:
        t = self.tenant_of_page(pid)
        if t < 0:
            return True  # untracked pages are outside arbitration
        if self.fast_pages[t] >= self.quota[t] + self.config.quota_slack:
            self.denied_quota[t] += 1
            return False
        if self.tokens[t] < 1.0:
            self.denied_token[t] += 1
            return False
        self.tokens[t] -= 1.0
        return True

    def refund_promotion(self, pid: int) -> None:
        """Return the token of an admitted promotion whose migration
        failed (e.g. no free fast frame) — pressure on the fast tier
        must not drain a well-behaved tenant's bucket."""
        t = self.tenant_of_page(pid)
        if t >= 0:
            self.tokens[t] = min(self.tokens[t] + 1.0, self._burst[t])

    # ---------------------------------------------------------------- #
    # serving signal: batch-class admission shedding
    # ---------------------------------------------------------------- #
    def shed_batch_request(self, pool) -> bool:
        """Shed a batch-class admission while the fast tier is under
        reclaim pressure *and* the arbiter is actively holding some
        tenant over quota — admitting more batch load at that point
        thrashes the fast tier the higher classes are being protected
        into.

        Pressure is ``free <= wm_demote`` (not the strict background
        trigger): steady-state reclaim parks free frames exactly *at*
        the demote watermark, and a fully-subscribed fast tier plus an
        over-quota tenant is precisely when new batch pages would evict
        protected residency.
        """
        if pool.free_frames(Tier.FAST) > pool.wm_demote:
            return False
        shed = bool(
            (self.fast_pages > self.quota + self.config.quota_slack).any()
        )
        if shed:
            self.shed_total += 1
        return shed

    # ---------------------------------------------------------------- #
    # serving signal: shed-vs-evict relief + victim ordering
    # ---------------------------------------------------------------- #
    def _fast_pressure(self, pool) -> bool:
        """Same trigger as :meth:`shed_batch_request`: the fast tier sits
        at (or under) the reclaim watermark while some tenant is over
        quota — new allocations would thrash protected residency."""
        if pool.free_frames(Tier.FAST) > pool.wm_demote:
            return False
        return bool(
            (self.fast_pages > self.quota + self.config.quota_slack).any()
        )

    def relief_action(self, pool) -> str:
        """Escalating relief: pressure sheds first, persistence evicts.

        Admission shedding only stops *new* batch work — lanes already
        decoding keep their residency.  When ``evict_after`` consecutive
        queries stay pressured, shedding has demonstrably not drained
        the fast tier and the front end is told to pick running victims
        (:meth:`order_pressure_victims`).  The streak resets the moment
        pressure clears (a relieved tier de-escalates immediately) and
        after every eviction recommendation — evicting a victim takes a
        few steps to actually free frames, so back-to-back "evict"
        verdicts would thrash running lanes faster than the relief they
        buy can land.
        """
        if not self._fast_pressure(pool):
            self._pressure_streak = 0
            return "none"
        self._pressure_streak += 1
        if self._pressure_streak >= self.config.evict_after:
            self._pressure_streak = 0
            self.evictions_recommended += 1
            return "evict"
        return "shed"

    def order_pressure_victims(
        self, candidates: Sequence[VictimCandidate], pool
    ) -> List[VictimCandidate]:
        """Order victims by **lowest share × coldest residency** first.

        A candidate's score is its tenant's fast-tier share multiplied
        by how *warm* its pages run — the fraction of its live pages
        that are fast-resident plus the fraction on the active list.  A
        low-priority tenant whose lane mostly reads the slow tier
        anyway scores lowest: pausing or evicting it frees (or cools)
        the most contested frames while costing the least protected
        work.  Ties break on the front end's key so the order is
        deterministic across engines.
        """
        if not candidates:
            return []
        shares = self.quota / max(1, self.fast_frames)

        def score(c: VictimCandidate) -> float:
            share = (
                float(shares[c.tenant])
                if 0 <= c.tenant < self.n_tenants else 1.0
            )
            live = [p for p in c.pids if pool.has_page(p)]
            if live:
                fast = sum(
                    1 for p in live if pool.tier_of(p) == Tier.FAST
                ) / len(live)
                active = sum(1 for p in live if pool.is_active(p)) / len(live)
                warmth = 0.5 * (fast + active)
            else:
                warmth = 0.0
            return share * (0.05 + warmth)

        return sorted(candidates, key=lambda c: (score(c), c.key))

    # ---------------------------------------------------------------- #
    # interval close: violations, dynamic re-division, token refill
    # ---------------------------------------------------------------- #
    def note_interval(self) -> None:
        self._record_interval()
        over = self.fast_pages > self.quota + self.config.quota_slack
        if over.any():
            self.quota_violation_intervals += 1
            self.violations_by_tenant += over
        super().note_interval()  # folds access counts into the EWMA
        if self.config.mode == "dynamic":
            self.quota = dynamic_quotas(
                self.config, self.weights, self.hot_ewma, self.fast_frames
            )
        self.tokens = np.minimum(self.tokens + self._refill, self._burst)

    # ---------------------------------------------------------------- #
    # observability
    # ---------------------------------------------------------------- #
    #: Default per-interval decision records retained (oldest dropped
    #: beyond this); override per run via ``QosConfig.timeline_max``.
    TIMELINE_MAX = 512

    @property
    def timeline_max(self) -> int:
        """The effective decision-timeline bound for this arbiter."""
        cfg = self.config.timeline_max
        return int(cfg) if cfg is not None else int(self.TIMELINE_MAX)

    def _record_interval(self) -> None:
        """Append this interval's decision deltas to the timeline.

        Called at the top of every ``note_interval`` override (the
        slowdown controller bypasses the arbiter's, so it calls this
        directly).  Deltas are derived from cumulative counters, which
        are bit-identical across engines — so the timeline is too.
        """
        cur = {
            "steered": int(self.steered_total),
            "shed": int(self.shed_total),
            "denied_quota": int(np.sum(self.denied_quota)),
            "denied_token": int(np.sum(self.denied_token)),
            "promoted": int(np.sum(self.promoted_total)),
            "demoted": int(np.sum(self.demoted_total)),
        }
        prev = self._tl_prev or {k: 0 for k in cur}
        entry: Dict = {"interval": int(self.intervals)}
        entry.update({k: cur[k] - prev.get(k, 0) for k in cur})
        shares = getattr(self, "shares", None)
        if shares is None:
            shares = self.quota / max(1, self.fast_frames)
        entry["shares"] = [round(float(s), 4) for s in shares]
        self._tl_prev = cur
        self.timeline.append(entry)
        limit = self.timeline_max
        if len(self.timeline) > limit:
            del self.timeline[: len(self.timeline) - limit]

    def fleet_telemetry(self) -> Dict[str, np.ndarray]:
        """Ledger counters + arbitration deltas for a coordinator tick."""
        out = super().fleet_telemetry()
        out.update({
            "denied_quota": self.denied_quota.copy(),
            "denied_token": self.denied_token.copy(),
            "steered_total": int(self.steered_total),
            "shed_total": int(self.shed_total),
            "classes": list(self.classes),
            "quota": self.quota.copy(),
        })
        return out

    def qos_summary(self) -> Optional[Dict]:
        return {
            "mode": self.config.mode,
            "classes": list(self.classes),
            "quota": [round(float(q), 2) for q in self.quota],
            "fast_pages": [int(x) for x in self.fast_pages],
            "slow_pages": [int(x) for x in self.slow_pages],
            "promoted": [int(x) for x in self.promoted_total],
            "demoted": [int(x) for x in self.demoted_total],
            "denied_quota": [int(x) for x in self.denied_quota],
            "denied_token": [int(x) for x in self.denied_token],
            "quota_violation_intervals": int(self.quota_violation_intervals),
            "violations_by_tenant": [int(x) for x in self.violations_by_tenant],
            "steered_total": int(self.steered_total),
            "shed_total": int(self.shed_total),
            "evictions_recommended": int(self.evictions_recommended),
            "timeline": [dict(e) for e in self.timeline],
        }
