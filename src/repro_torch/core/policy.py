"""The placement-policy protocol and registry.

Every placement policy — TPP (§5) and the paper's comparison systems
(§6.3) — implements one uniform interface:

    step(slow_hits, fast_hits) -> StepReport

``slow_hits`` / ``fast_hits`` are the page ids whose accesses this step
were served by the slow / fast tier (the engine's block-table lookups
make these free to collect; DESIGN.md §2).  Policies that do not sample
the fast tier (TPP restricts NUMA-hint faults to the slow node) simply
ignore ``fast_hits`` — callers never special-case on the policy name.

Policies drive a pool through the *accessor surface* described by
:class:`PlacementPool` instead of reaching into ``pool.pages`` — that is
what lets the same policy code run unchanged against both the reference
``PagePool`` and the struct-of-arrays ``VectorPagePool``
(``repro_torch.core.engine``), with bit-identical ``VmStat`` trajectories.
"""

from __future__ import annotations

import dataclasses
from typing import (
    Dict,
    List,
    Optional,
    Protocol,
    Sequence,
    Type,
    runtime_checkable,
)

from repro_torch.core.types import Tier


@dataclasses.dataclass
class StepReport:
    """What one policy step did (for benchmarks and tests)."""

    demoted: int = 0
    promoted: int = 0
    evicted: int = 0
    demote_failed: int = 0
    promote_filtered: int = 0
    promote_failed: int = 0


@runtime_checkable
class PlacementPolicy(Protocol):
    """Uniform control-loop interface all policies implement."""

    name: str

    def step(
        self,
        slow_hits: Sequence[int] = (),
        fast_hits: Sequence[int] = (),
    ) -> StepReport: ...


class PlacementPool(Protocol):
    """The pool surface policies are written against.

    Implemented by both :class:`~repro_torch.core.page_pool.PagePool`
    (reference, dict-of-``Page``) and
    :class:`~repro_torch.core.engine.VectorPagePool` (struct-of-arrays).
    Only the subset policies use is listed; see DESIGN.md §3.

    Every pool also carries a ``control``
    (:class:`~repro_torch.core.control.TieringControl`) — the tiering control
    plane its allocate/demote/promote decision points dispatch through;
    policies never consult it directly (DESIGN.md §8).
    """

    step: int

    # liveness / per-page state
    def has_page(self, pid: int) -> bool: ...
    def tier_of(self, pid: int) -> Tier: ...
    def is_slow_live(self, pid: int) -> bool: ...
    def is_active(self, pid: int) -> bool: ...
    def is_demoted(self, pid: int) -> bool: ...
    def is_pinned(self, pid: int) -> bool: ...
    def touch_count_of(self, pid: int) -> int: ...

    # LRU transitions
    def activate(self, pid: int) -> None: ...
    def age_active(self, tier: Tier, inactive_ratio: float = 1.0) -> int: ...
    def scan_reclaim_candidates(self, tier: Tier, nr_to_scan: int) -> List[int]: ...
    def demotion_victims(self, limit: int) -> List[int]: ...

    # migration (batched forms are exactly equivalent to per-pid calls)
    def demote_page(self, pid: int): ...
    def demote_pages(self, pids): ...
    def promote_page(self, pid: int): ...
    def promote_pages(self, pids): ...
    def evict_page(self, pid: int) -> None: ...

    # watermarks / frames
    def free_frames(self, tier: Tier) -> int: ...
    def under_alloc_watermark(self) -> bool: ...


#: name -> policy class.  Policies self-register via :func:`register_policy`.
POLICY_REGISTRY: Dict[str, Type] = {}


def register_policy(cls):
    """Class decorator: add a policy to the registry under ``cls.name``."""
    POLICY_REGISTRY[cls.name] = cls
    return cls


def make_policy(name: str, pool, seed: int = 0) -> PlacementPolicy:
    """Instantiate a registered policy by name (protocol dispatch)."""
    # Importing the implementation modules populates the registry.
    from repro_torch.core import baselines as _baselines  # noqa: F401
    from repro_torch.core import tpp as _tpp  # noqa: F401

    if name not in POLICY_REGISTRY:
        raise ValueError(
            f"unknown policy {name!r}; choose from {sorted(POLICY_REGISTRY)}"
        )
    return POLICY_REGISTRY[name](pool, seed=seed)
