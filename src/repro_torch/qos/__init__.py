"""Multi-tenant QoS: fair tiering control over the placement engines.

TPP (§6) is tenant-blind — on a shared host every tenant competes for
the same fast-tier headroom, so a churny low-value job can evict a
latency-critical service's hot pages.  This package provides the
tenant-aware implementations of the core tiering control plane
(:class:`~repro_torch.core.control.TieringControl`, attached as
``pool.control``; DESIGN.md §8):

* :class:`~repro_torch.qos.accounting.TenantAccounting` — telemetry only:
  vectorized per-tenant residency/hotness/migration accounting with
  every decision point neutral (placement unchanged).
* :class:`~repro_torch.qos.arbiter.QosArbiter` — telemetry + arbitration at
  all three decision points: over-quota tenants' new pages steer
  slow-first at allocation (``pgalloc_steered``), their reclaim
  candidates demote first, and promotions are admitted in batch against
  per-tenant quotas + token buckets
  (:class:`~repro_torch.qos.quota.QosConfig`: static shares or dynamic
  hotness-weighted re-division, priority classes
  ``latency_critical > standard > batch``).
* :class:`~repro_torch.qos.controller.SlowdownController` — the Equilibria
  path: replaces static priority weights with a proportional feedback
  loop that re-divides fair shares each interval from *measured*
  per-tenant slowdowns toward per-class SLO targets
  (:class:`~repro_torch.qos.controller.SlowdownControllerConfig`).

:func:`make_control` maps a config (or ready control) onto the right
implementation — the serving engine uses it.

Copies of the JAX package's ``repro.qos`` modules with the same
behaviour (NumPy only), over the port's ``core.control`` and
``core.types``.
"""

from repro_torch.core.control import TieringControl
from repro_torch.qos.accounting import TenantAccounting
from repro_torch.qos.arbiter import QosArbiter
from repro_torch.qos.controller import (
    DEFAULT_SLO,
    SlowdownController,
    SlowdownControllerConfig,
    proportional_share_update,
)
from repro_torch.qos.quota import (
    DEFAULT_PRIORITY,
    QOS_CLASSES,
    QosConfig,
    class_weights,
    dynamic_quotas,
    static_quotas,
    token_refill,
)


def make_control(spec, n_tenants: int, fast_frames: int) -> TieringControl:
    """Build the control a ``qos=`` argument asks for.

    ``spec`` may be a :class:`QosConfig` (→ :class:`QosArbiter`), a
    :class:`SlowdownControllerConfig` (→ :class:`SlowdownController`),
    or an already-constructed :class:`TieringControl` (used as-is).
    """
    if isinstance(spec, TieringControl):
        return spec
    if isinstance(spec, SlowdownControllerConfig):
        return SlowdownController(n_tenants, fast_frames, config=spec)
    if isinstance(spec, QosConfig):
        return QosArbiter(n_tenants, fast_frames, config=spec)
    raise TypeError(
        f"qos spec must be a QosConfig, SlowdownControllerConfig or "
        f"TieringControl, got {type(spec).__name__}"
    )


__all__ = [
    "DEFAULT_PRIORITY",
    "DEFAULT_SLO",
    "QOS_CLASSES",
    "QosArbiter",
    "QosConfig",
    "SlowdownController",
    "SlowdownControllerConfig",
    "TenantAccounting",
    "class_weights",
    "dynamic_quotas",
    "make_control",
    "proportional_share_update",
    "static_quotas",
    "token_refill",
]
