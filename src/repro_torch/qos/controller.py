"""Slowdown-targeted tiering control: a proportional SLO feedback loop.

:class:`SlowdownController` is the Equilibria-style alternative to the
static priority weights of :class:`~repro_torch.qos.arbiter.QosArbiter`:
instead of dividing the fast tier by fixed class weights, it *measures*
each tenant's slowdown every interval and re-divides fair shares so the
measured slowdowns converge to per-class SLO targets.

Measurement.  The accounting ledger's per-interval fast/slow access
split gives the modeled per-tenant memory slowdown

    s_t = (fast_t + slow_cost * slow_t) / (fast_t + slow_t)

(ideal all-fast = 1.0 — the same definition as
``SimResult.tenant_slowdowns``), smoothed with an EWMA so one bursty
interval does not whipsaw the shares.

Control law.  Each interval, every tenant's share is scaled by its
relative SLO error and renormalized:

    share_t <- share_t * (1 + gain * (s_t / slo_t - 1))

A tenant running slower than its target grows its fast-tier share (and
its promotion-token refill); one running faster than it needs gives
share back.  Shares are floored so an idle tenant is never starved, and
quotas are ``share_t * fast_frames``.  At the fair point every tenant
sits at its own target — the *targets* encode business priority
(latency-critical gets a tight SLO, batch a loose one) instead of
abstract weights.

Everything else — allocation steering, victim ordering, batched token
admission, the serving shed signal — is inherited from the arbiter, so
the controller is a drop-in :class:`~repro_torch.core.control.TieringControl`
for either pool engine, the simulator (``TieredSimulator(qos=
SlowdownControllerConfig(...))``) and the serving engine.  Decisions
are pure functions of counters that are bit-identical across engines,
so placement under the controller is too (tests/test_qos.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from repro_torch.qos.arbiter import QosArbiter
from repro_torch.qos.quota import QosConfig, token_refill

#: Default per-class slowdown targets (ideal all-fast = 1.0).  The
#: spread encodes priority: latency-critical converges near-local while
#: batch absorbs the tiering penalty.
DEFAULT_SLO: Dict[str, float] = {
    "latency_critical": 1.2,
    "standard": 1.8,
    "batch": 2.6,
}


def proportional_share_update(
    shares: np.ndarray,
    measured: np.ndarray,
    targets: np.ndarray,
    gain: float,
    floor: float,
) -> np.ndarray:
    """One Equilibria-style proportional step on a fair-share vector.

    Each share is scaled by its relative SLO error
    (``1 + gain * (measured/target - 1)``, clipped at 0.05 so one
    wildly-off entry cannot zero a share in a single step), renormalized,
    floored at ``floor`` and renormalized again.  This is the control
    law of :class:`SlowdownController` (per-tenant shares of one host's
    fast tier) and of the fleet coordinator
    (:class:`~repro_torch.fleet.coordinator.FleetCoordinator`, per-shard-pool
    shares of the global fast-tier budget) — one law, two altitudes.
    """
    err = measured / targets - 1.0
    shares = shares * np.maximum(1.0 + gain * err, 0.05)
    shares = np.maximum(shares / shares.sum(), floor)
    return shares / shares.sum()


@dataclasses.dataclass(frozen=True)
class SlowdownControllerConfig:
    """Tunables of the slowdown controller.

    * ``slo`` — class name → slowdown target (see :data:`DEFAULT_SLO`).
    * ``gain`` — proportional gain on the relative SLO error per
      interval (0.5 halves the error geometrically when the plant is
      roughly linear in share).
    * ``slow_cost`` — modeled slow-tier access cost used in the
      measured-slowdown estimate (match the simulator's ``slow_cost``).
    * ``measure_alpha`` — EWMA smoothing of the measured slowdowns.
    * ``share_floor`` — minimum fast-tier share any tenant keeps.
    * ``qos`` — the underlying arbiter tunables (token bucket, slack,
      steering).  Its quota ``mode`` is ignored — the controller *is*
      the quota policy.
    """

    slo: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_SLO)
    )
    gain: float = 0.5
    slow_cost: float = 3.0
    measure_alpha: float = 0.5
    share_floor: float = 0.05
    qos: QosConfig = dataclasses.field(default_factory=QosConfig)

    def __post_init__(self) -> None:
        for cls in self.qos.priority:
            if cls not in self.slo:
                raise ValueError(
                    f"no SLO target for class {cls!r}; slo must cover "
                    f"{sorted(self.qos.priority)}"
                )
        if self.gain <= 0:
            raise ValueError("gain must be positive")


class SlowdownController(QosArbiter):
    """Proportional per-tenant slowdown → fair-share feedback loop."""

    def __init__(
        self,
        n_tenants: int,
        fast_frames: int,
        config: Optional[SlowdownControllerConfig] = None,
        classes: Optional[Sequence[str]] = None,
    ) -> None:
        self.ctrl = config or SlowdownControllerConfig()
        super().__init__(
            n_tenants, fast_frames, config=self.ctrl.qos, classes=classes
        )
        # Measured slowdown EWMA; seeded at each tenant's target so the
        # loop starts from "on SLO" rather than a fictitious error.
        self.slowdown_ewma = self.targets.copy()
        self._measured = np.zeros(self.n_tenants, np.float64)

    # ---------------------------------------------------------------- #
    # shares: controller state replaces the weight-derived quotas
    # ---------------------------------------------------------------- #
    def _rebuild_shares(self) -> None:
        """(Re)size controller state and derive quotas from shares.

        Called by the arbiter on construction and on tenant growth /
        class changes; the weight-proportional division is only the
        *initial* share vector — afterwards the feedback loop owns it.
        """
        super()._rebuild_shares()  # weights, weight-derived quota, tokens
        self.targets = np.asarray(
            [float(self.ctrl.slo[c]) for c in self.classes], np.float64
        )
        shares = getattr(self, "shares", None)
        if shares is None or len(shares) != self.n_tenants:
            old = 0 if shares is None else len(shares)
            grown = self.weights / self.weights.sum()
            if shares is not None:
                # keep converged shares; new tenants enter at their
                # weight share, then everything renormalizes
                grown[:old] = shares * (1.0 - grown[old:].sum())
            self.shares = grown / grown.sum()
        if hasattr(self, "slowdown_ewma") and \
                len(self.slowdown_ewma) != self.n_tenants:
            pad = self.n_tenants - len(self.slowdown_ewma)
            self.slowdown_ewma = np.concatenate(
                [self.slowdown_ewma, self.targets[-pad:]])
            self._measured = np.concatenate(
                [self._measured, np.zeros(pad, np.float64)])
        self.quota = self._quotas_from_shares()
        # token refill follows the controller's shares, not class weights
        self._refill = token_refill(self.config, self.shares)
        self._burst = self.config.token_burst * np.maximum(self._refill, 1.0)

    def _quotas_from_shares(self) -> np.ndarray:
        floor = self.ctrl.share_floor * self.fast_frames
        return np.maximum(self.shares * self.fast_frames, floor)

    # ---------------------------------------------------------------- #
    # interval close: measure → error → share update
    # ---------------------------------------------------------------- #
    def note_interval(self) -> None:
        self._record_interval()  # decision timeline (arbiter helper)
        slack = self.config.quota_slack
        over = self.fast_pages > self.quota + slack
        if over.any():
            self.quota_violation_intervals += 1
            self.violations_by_tenant += over
        fast = self.access_fast_interval.astype(np.float64)
        slow = self.access_slow_interval.astype(np.float64)
        total = fast + slow
        active = total > 0
        measured = np.where(
            active,
            (fast + self.ctrl.slow_cost * slow) / np.maximum(total, 1.0),
            self.slowdown_ewma,  # idle tenants hold their estimate
        )
        self._measured = measured
        a = self.ctrl.measure_alpha
        self.slowdown_ewma = (1.0 - a) * self.slowdown_ewma + a * measured
        # fold access counts into the hotness EWMA + reset interval bins
        # (grandparent: the arbiter's note_interval would re-divide by
        # weights, which the controller replaces)
        from repro_torch.qos.accounting import TenantAccounting

        TenantAccounting.note_interval(self)
        # proportional update on the relative SLO error, renormalized
        self.shares = proportional_share_update(
            self.shares, self.slowdown_ewma, self.targets,
            self.ctrl.gain, self.ctrl.share_floor,
        )
        self.quota = self._quotas_from_shares()
        self._refill = token_refill(self.config, self.shares)
        self._burst = self.config.token_burst * np.maximum(self._refill, 1.0)
        self.tokens = np.minimum(self.tokens + self._refill, self._burst)

    # ---------------------------------------------------------------- #
    # observability
    # ---------------------------------------------------------------- #
    def qos_summary(self) -> Optional[Dict]:
        out = super().qos_summary()
        out.update({
            "mode": "slowdown_controller",
            "slo_targets": [round(float(t), 3) for t in self.targets],
            "measured_slowdown": [
                round(float(s), 4) for s in self._measured
            ],
            "slowdown_ewma": [
                round(float(s), 4) for s in self.slowdown_ewma
            ],
            "shares": [round(float(s), 4) for s in self.shares],
        })
        return out
