"""TPP core of the PyTorch port: the host-side placement engine.

Copies of the JAX package's ``repro.core`` modules, with the same
behaviour (NumPy and the standard library only):

* :class:`~repro_torch.core.types.TppConfig`, :class:`Tier`,
  :class:`PageType` — configuration and enums.
* :class:`~repro_torch.core.page_pool.PagePool` — two-tier pool, LRU and
  watermarks.
* :class:`~repro_torch.core.control.TieringControl` /
  :data:`NULL_CONTROL` — the control-plane decision surface.
* :func:`~repro_torch.core.policy.make_policy`,
  :class:`~repro_torch.core.tpp.TppPolicy` and the paper's comparison
  baselines of :mod:`repro_torch.core.baselines` (``linux``,
  ``numa_balancing``, ``autotiering``, ``ideal``).
* :class:`~repro_torch.core.engine.VectorPagePool` — the struct-of-arrays
  vectorized engine (same semantics, fleet-scale throughput) and
  :func:`~repro_torch.core.engine.make_pool` — engine factory.
* :class:`~repro_torch.core.chameleon.Chameleon` — the §3 profiler.
* :class:`~repro_torch.core.simulator.TieredSimulator` — trace-driven
  harness (``engine="reference" | "vectorized"``).
* :func:`~repro_torch.core.trace.make_trace` and
  :class:`~repro_torch.core.trace.MultiTenantTrace` — synthetic workload
  traces and the co-running mixer (``make_trace("web+cache1")``).

The port keeps its own copy so that it imports nothing of ``repro``.
"""

from repro_torch.core.chameleon import Chameleon
from repro_torch.core.control import (
    NULL_CONTROL,
    AllocRequest,
    NullControl,
    TieringControl,
)
from repro_torch.core.engine import PageView, VectorPagePool, make_pool
from repro_torch.core.page_pool import Page, PagePool
from repro_torch.core.policy import (
    POLICY_REGISTRY,
    PlacementPolicy,
    StepReport,
    make_policy,
    register_policy,
)
from repro_torch.core.simulator import (
    ENGINES,
    SimResult,
    TieredSimulator,
    run_policy_comparison,
)
from repro_torch.core.tpp import TppPolicy
from repro_torch.core.trace import (
    WORKLOADS,
    MultiTenantTrace,
    ReplayTrace,
    TraceGenerator,
    make_trace,
    record_trace,
    workload_total_pages,
)
from repro_torch.core.types import (
    DemoteFail,
    PageFlags,
    PageType,
    PromoteFail,
    Tier,
    TppConfig,
)
from repro_torch.core.vmstat import VmStat

__all__ = [
    "AllocRequest",
    "Chameleon",
    "DemoteFail",
    "ENGINES",
    "MultiTenantTrace",
    "NULL_CONTROL",
    "NullControl",
    "POLICY_REGISTRY",
    "Page",
    "PageFlags",
    "PagePool",
    "PageType",
    "PageView",
    "PlacementPolicy",
    "PromoteFail",
    "ReplayTrace",
    "SimResult",
    "StepReport",
    "Tier",
    "TieredSimulator",
    "TieringControl",
    "TppConfig",
    "TppPolicy",
    "TraceGenerator",
    "VectorPagePool",
    "VmStat",
    "WORKLOADS",
    "make_policy",
    "make_pool",
    "make_trace",
    "record_trace",
    "register_policy",
    "run_policy_comparison",
    "workload_total_pages",
]
