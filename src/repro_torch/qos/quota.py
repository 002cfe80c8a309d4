"""Per-tenant fast-tier quotas and promotion token budgets.

Two quota modes (Equilibria-style fair shares):

* **static** — fixed fast-tier shares per tenant (explicit
  ``QosConfig.shares`` or derived from priority weights);
* **dynamic** — every interval the fast tier is re-divided
  proportionally to each tenant's *measured hotness* (the accounting
  EWMA) scaled by its priority-class weight, with a configurable floor
  so an idle tenant is never starved to zero.

Priority classes order tenants by business value:
``latency_critical > standard > batch``.  The class weight multiplies a
tenant's demand in the fair-share division and its promotion
token-bucket refill rate, so a latency-critical tenant both holds more
fast-tier residency and promotes back faster after a phase change.

All functions are pure NumPy over accounting counters that are
bit-identical across the reference and vectorized engines — so quota
trajectories (and therefore every arbitration decision) are too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

#: Priority classes, highest value first.
QOS_CLASSES: Tuple[str, ...] = ("latency_critical", "standard", "batch")

#: Default priority weights per class (relative fair-share multipliers).
DEFAULT_PRIORITY: Dict[str, float] = {
    "latency_critical": 4.0,
    "standard": 2.0,
    "batch": 1.0,
}


@dataclasses.dataclass(frozen=True)
class QosConfig:
    """Tunables of the QoS arbiter.

    * ``mode`` — ``"static"`` (fixed shares) or ``"dynamic"``
      (hotness-proportional re-division each interval).
    * ``classes`` — per-tenant priority class names, in tenant order;
      tenants beyond the tuple default to ``"standard"``.
    * ``shares`` — explicit static fast-tier shares (normalized
      internally); ``None`` derives shares from the class weights.
    * ``priority`` — class name → weight (defaults
      ``latency_critical=4, standard=2, batch=1``).
    * ``ewma_alpha`` — hotness EWMA smoothing for the dynamic mode.
    * ``min_share`` — fast-tier share floor any tenant keeps in the
      dynamic mode (quotas are soft caps, so the floor is not
      renormalized away from the other tenants).
    * ``quota_slack`` — frames a tenant may exceed its quota by before
      promotion admission denies it and demotion targets it first.
    * ``steer_allocation`` — steer over-quota tenants' *new* pages
      slow-first at allocation time (§5.4 generalized tenant-aware;
      counted as ``pgalloc_steered``).  Off restores PR-3-style
      demotion/promotion-only arbitration.
    * ``promote_tokens_per_interval`` — total promotion tokens minted
      per interval, split across tenants by priority weight (the
      per-tenant token-bucket refill).
    * ``token_burst`` — bucket capacity as a multiple of the tenant's
      per-interval refill.
    * ``timeline_max`` — decision-timeline entries retained (oldest
      dropped beyond this).  The fleet coordinator consumes the
      timeline, so long fleet runs need a bound sized to their
      coordination horizon; ``None`` keeps the arbiter's default
      (``QosArbiter.TIMELINE_MAX``).
    * ``evict_after`` — consecutive pressured ``relief_action`` queries
      before the arbiter escalates a serving front end from admission
      shedding to pause/evict victim selection (shedding needs a few
      steps to drain before evicting running work is justified).
    """

    mode: str = "dynamic"
    classes: Tuple[str, ...] = ()
    shares: Optional[Tuple[float, ...]] = None
    priority: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_PRIORITY)
    )
    ewma_alpha: float = 0.3
    min_share: float = 0.05
    quota_slack: int = 0
    steer_allocation: bool = True
    promote_tokens_per_interval: float = 64.0
    token_burst: float = 2.0
    timeline_max: Optional[int] = None
    evict_after: int = 4

    def __post_init__(self) -> None:
        if self.mode not in ("static", "dynamic"):
            raise ValueError(
                f"unknown quota mode {self.mode!r}; choose static|dynamic"
            )
        if self.evict_after < 1:
            raise ValueError(
                f"evict_after must be >= 1 (got {self.evict_after})"
            )
        if self.timeline_max is not None and self.timeline_max < 1:
            raise ValueError(
                f"timeline_max must be >= 1 (got {self.timeline_max})"
            )
        for cls in self.classes:
            if cls not in self.priority:
                raise ValueError(
                    f"unknown qos class {cls!r}; choose from "
                    f"{sorted(self.priority)}"
                )

    def class_of(self, tenant: int) -> str:
        return self.classes[tenant] if tenant < len(self.classes) else "standard"


def class_weights(config: QosConfig, classes: Sequence[str]) -> np.ndarray:
    """Priority weight per tenant, from its class name."""
    return np.asarray(
        [float(config.priority[c]) for c in classes], np.float64
    )


def static_quotas(
    config: QosConfig, weights: np.ndarray, fast_frames: int
) -> np.ndarray:
    """Fixed fast-tier quotas: explicit shares, else weight-proportional."""
    n = len(weights)
    if config.shares is not None:
        shares = np.asarray(config.shares[:n], np.float64)
        if len(shares) < n:  # tenants beyond the tuple share equally
            shares = np.concatenate(
                [shares, np.full(n - len(shares), shares.mean() if len(shares)
                                 else 1.0)]
            )
    else:
        shares = weights.copy()
    total = shares.sum()
    if total <= 0:
        shares = np.ones(n, np.float64)
        total = float(n)
    return fast_frames * shares / total


def dynamic_quotas(
    config: QosConfig,
    weights: np.ndarray,
    hot_ewma: np.ndarray,
    fast_frames: int,
) -> np.ndarray:
    """Hotness-proportional fair shares, weighted by priority class.

    ``demand_t = weight_t * max(hot_t, 1)``; the fast tier is divided
    proportionally, then each tenant's quota is floored at
    ``min_share * fast_frames`` (soft caps — no renormalization).
    """
    demand = weights * np.maximum(hot_ewma, 1.0)
    total = demand.sum()
    if total <= 0:
        return static_quotas(config, weights, fast_frames)
    quotas = fast_frames * demand / total
    return np.maximum(quotas, config.min_share * fast_frames)


def token_refill(config: QosConfig, weights: np.ndarray) -> np.ndarray:
    """Per-tenant promotion tokens minted per interval (weight split)."""
    total_w = weights.sum()
    if total_w <= 0:
        return np.full(len(weights),
                       config.promote_tokens_per_interval / max(1, len(weights)))
    return config.promote_tokens_per_interval * weights / total_w
