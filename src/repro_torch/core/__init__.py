"""TPP core of the PyTorch port: the host-side placement engine.

Copies of the JAX package's ``repro.core`` modules that the tiered-KV
decode path needs, with the same behaviour (NumPy and the standard
library only):

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

The port keeps its own copy so that it imports nothing of ``repro``.
"""

from repro_torch.core.control import (
    NULL_CONTROL,
    AllocRequest,
    NullControl,
    TieringControl,
)
from repro_torch.core.page_pool import Page, PagePool
from repro_torch.core.policy import (
    POLICY_REGISTRY,
    PlacementPolicy,
    StepReport,
    make_policy,
    register_policy,
)
from repro_torch.core.tpp import TppPolicy
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
    "DemoteFail",
    "NULL_CONTROL",
    "NullControl",
    "POLICY_REGISTRY",
    "Page",
    "PagePool",
    "PageFlags",
    "PageType",
    "PlacementPolicy",
    "PromoteFail",
    "StepReport",
    "Tier",
    "TieringControl",
    "TppConfig",
    "TppPolicy",
    "VmStat",
    "make_policy",
    "register_policy",
]
