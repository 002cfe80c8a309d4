"""The tiering control plane: a first-class decision surface for placement.

Every tiered-memory system tunes the same three levers — *where to
allocate* (TPP §5.4 type-aware allocation generalized to tenant-aware
steering), *what to demote* (§5.2 victim selection), and *what to
promote* (§5.3 admission).  :class:`TieringControl` makes those three
decision points an explicit, typed API that both page-pool engines
(:class:`~repro_torch.core.page_pool.PagePool` and
:class:`~repro_torch.core.engine.VectorPagePool`) dispatch through uniformly,
replacing the former nullable ``pool.qos`` attribute and its scattered
``if self.qos is not None`` checks.

Decision points (consulted by the pools):

* :meth:`~TieringControl.steer_allocation` — given an
  :class:`AllocRequest` (page type, tenant, the pool's §5.4 default
  preference), return the tier the new page should *prefer*.  The pool
  still owns watermark enforcement, so steering can never violate
  watermarks: a FAST preference falls back to SLOW below ``wm_min``, a
  SLOW preference falls back to FAST when the slow tier is full.  A
  steered placement (preference != the pool's default) is counted in
  ``VmStat.pgalloc_steered``.
* :meth:`~TieringControl.order_demotion_victims` — reorder (never grow
  or shrink) a reclaim-candidate list; both the LRU-tail scan and the
  frequency ranking pass through it.
* :meth:`~TieringControl.admit_promotions` — batched promotion
  admission: one boolean per candidate, exactly equivalent to asking
  per-pid in order (implementations must model intra-batch effects —
  e.g. token consumption and provisional residency of earlier
  admissions).  The returned mask length always equals the input
  length.

Lifecycle events (``note_*``) keep an implementation's ledger in sync
with the pool: allocation, free, demotion, promotion (scalar + batched
forms), the per-step access telemetry split by serving tier, and the
interval tick (``note_interval`` is driven by ``pool.end_interval``).

Implementations:

* :class:`NullControl` — the neutral control: default steering,
  identity victim order, admit-everything, no-op notes.  A pool with a
  ``NullControl`` attached is **bit-identical** (VmStat + placement) to
  the historical control-free pool; this is pinned by
  ``tests/test_control.py`` / ``tests/test_engine_parity.py``.
* :class:`~repro.qos.accounting.TenantAccounting` — telemetry only
  (neutral decisions + per-tenant ledger).
* :class:`~repro.qos.arbiter.QosArbiter` — quota/token arbitration +
  allocation steering.
* :class:`~repro.qos.controller.SlowdownController` — Equilibria-style
  proportional feedback on measured per-tenant slowdown toward SLO
  targets.

``steers_allocation`` is a declared capability, not a duck-typed hook:
when ``False`` (the default) the pools skip building
:class:`AllocRequest` objects on the allocation hot path and the
vectorized engine keeps its closed-form batched allocation; when
``True`` allocations route through the scalar path so per-allocation
steering decisions sequence exactly like the reference engine.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.types import PageType, Tier


@dataclasses.dataclass(frozen=True)
class VictimCandidate:
    """One pausable/evictable unit of work, as a front end presents it.

    The serving front end (``repro.traffic``) builds one candidate per
    occupied decode lane: ``key`` is the front end's handle (slot id),
    ``tenant``/``qos_class`` identify whose work it is, and ``pids`` are
    the live pages the unit would stop touching (pause) or free outright
    (evict).  The control plane only *orders* candidates — acting on
    them stays with the front end.
    """

    key: int
    tenant: int
    pids: Tuple[int, ...] = ()
    qos_class: str = "standard"


@dataclasses.dataclass(frozen=True)
class AllocRequest:
    """One allocation, as seen by the control plane.

    ``default`` is the pool's §5.4 preference (``prefer`` if the caller
    forced a tier, else slow-first for FILE pages under
    ``TppConfig.file_to_slow``, else fast-first) — a control that does
    not want to steer this request returns it unchanged.
    """

    page_type: PageType
    tenant: int = -1  # -1 = untracked (outside tenant arbitration)
    pinned: bool = False
    prefer: Optional[Tier] = None  # caller-forced tier (tests, baselines)
    default: Tier = Tier.FAST  # the pool's §5.4 preference


class TieringControl:
    """Neutral base control: every decision is the pool's default.

    Subclasses override the decision points they implement; the
    ``note_*`` defaults are no-ops so a control only pays for the
    telemetry it actually keeps.
    """

    #: Capability flag: True routes allocations through the scalar
    #: steering path (see module docstring).
    steers_allocation: bool = False

    # -------------------------- decision points ----------------------- #
    def steer_allocation(self, req: AllocRequest) -> Tier:
        return req.default

    def order_demotion_victims(self, pids: List[int]) -> List[int]:
        return pids

    def admit_promotions(self, pids: Sequence[int]) -> Sequence[bool]:
        """Batched admission; mask length == input length (invariant)."""
        return _TRUE_ONE if len(pids) == 1 else [True] * len(pids)

    def refund_promotion(self, pid: int) -> None:
        """Undo an admission whose migration then failed (no free frame)."""

    # -------------------------- fleet budget push-down ----------------- #
    def set_fast_budget(self, budget: int) -> None:
        """The host's fast-tier budget changed (fleet coordinator).

        Quota-keeping controls re-divide their tenant shares over the
        new capacity; stateless controls ignore it.  Driven by
        ``pool.set_fast_budget`` so one push-down call updates the
        watermarks and the ledger together.
        """

    # -------------------------- lifecycle notes ----------------------- #
    def note_alloc(self, pid: int, tenant: int, tier: int) -> None:
        """A page was allocated (scalar path)."""

    def note_alloc_many(self, pids, tenants, tiers) -> None:
        """A batch of pages was allocated (vectorized path)."""

    def note_free(self, pid: int, tier: int) -> None: ...

    def note_demote(self, pid: int) -> None: ...

    def note_demote_many(self, pids: np.ndarray) -> None: ...

    def note_promote(self, pid: int) -> None: ...

    def note_promote_many(self, pids: np.ndarray) -> None: ...

    def note_access_tiers(
        self, fast_counts: np.ndarray, slow_counts: np.ndarray
    ) -> None:
        """One step's per-tenant access counts, split by serving tier."""

    def note_hits(self, fast_pids: np.ndarray, slow_pids: np.ndarray) -> None:
        """One step's touched pids, split by serving tier (serving path)."""

    def note_interval(self) -> None:
        """Interval tick — driven by ``pool.end_interval()``."""

    # -------------------------- serving signals ----------------------- #
    def configure_tenant(self, tenant: int, qos_class: str) -> None:
        """A tenant appeared (or changed class) — e.g. serving
        ``add_request``.  Controls without per-tenant state ignore it;
        implementations may validate ``qos_class`` (raise ValueError)
        and must do so before mutating any state."""

    def shed_batch_request(self, pool) -> bool:
        """True when a batch-class admission should shed (fast tier under
        reclaim pressure while the control is protecting other tenants)."""
        return False

    def relief_action(self, pool) -> str:
        """What a serving front end should do about fast-tier pressure.

        ``"none"`` — no pressure, keep admitting; ``"shed"`` — refuse
        new batch-class work but leave running lanes alone; ``"evict"``
        — shedding alone has not relieved the fast tier, so the front
        end should pause/evict running victims (pick them with
        :meth:`order_pressure_victims`).  The neutral control never
        escalates: admission shedding is the only lever it knows.
        """
        return "none"

    def order_pressure_victims(
        self, candidates: Sequence["VictimCandidate"], pool
    ) -> List["VictimCandidate"]:
        """Order pause/evict victims, best-victim-first.

        Called by a front end when :meth:`relief_action` says
        ``"evict"``.  The neutral control recommends nobody (an empty
        list) — only an arbitrating control has the share/residency
        ledger the Equilibria-style victim ordering (lowest share ×
        coldest residency) needs.
        """
        return []

    # -------------------------- observability ------------------------- #
    def qos_summary(self) -> Optional[dict]:
        """Arbitration summary for results/stats; None when not arbitrating."""
        return None


_TRUE_ONE = (True,)


class NullControl(TieringControl):
    """The disabled control plane: bit-identical to a control-free pool."""

    __slots__ = ()


#: Shared singleton — the pools' default ``control``.  Stateless, so one
#: instance can serve every pool.
NULL_CONTROL = NullControl()
