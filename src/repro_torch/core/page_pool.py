"""Two-tier page pool: frames, free lists, watermarks, LRU integration.

This is the host-side reference implementation of the memory manager the
TPP policy (``repro_torch.core.tpp``) drives.  It owns:

* physical **frames** per tier with free-frame stacks,
* the **logical page table** (tier, frame, type, flags, touch metadata),
* the per-tier **LRU lists** (``repro_torch.core.lru``),
* the **watermark** machinery of §5.2 (min / alloc / demote, decoupled),
* the ``VmStat`` counters of §5.5.

Policies (TPP and the baselines of ``repro_torch.core.baselines``) never touch
frames directly — they call ``allocate`` / ``demote_page`` /
``promote_page`` / ``evict_page`` and read LRU/watermark state.  The device
data plane (serving engine) mirrors migrations with real buffer copies via
the migration ops in ``repro_torch.kernels``.

A copy of ``repro.core.page_pool`` with the same behaviour.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.analysis.tiersan import tiersan_from_env
from repro_torch.core.control import NULL_CONTROL, AllocRequest, TieringControl
from repro_torch.core.lru import NodeLru
from repro_torch.core.types import (
    DemoteFail,
    PageFlags,
    PageType,
    PromoteFail,
    Tier,
    TppConfig,
)
from repro_torch.core.vmstat import VmStat


@dataclasses.dataclass
class Page:
    """Logical page table entry."""

    pid: int
    page_type: PageType
    tier: Tier
    frame: int
    flags: PageFlags = PageFlags.NONE
    birth_step: int = 0
    last_touch_step: int = 0
    touch_count: int = 0
    # 64-bit access history bitmap (Chameleon-style; bit0 = current interval)
    history: int = 0

    @property
    def active(self) -> bool:
        return bool(self.flags & PageFlags.ACTIVE)

    @property
    def accessed(self) -> bool:
        return bool(self.flags & PageFlags.ACCESSED)

    @property
    def demoted(self) -> bool:
        return bool(self.flags & PageFlags.DEMOTED)

    @property
    def pinned(self) -> bool:
        return bool(self.flags & PageFlags.UNEVICTABLE)


class PagePool:
    """Two-tier frame allocator + logical page table + LRU + watermarks."""

    def __init__(
        self,
        num_fast: int,
        num_slow: int,
        config: Optional[TppConfig] = None,
        on_migrate: Optional[Callable[[int, Tier, int, Tier, int], None]] = None,
        on_evict: Optional[Callable[[int], None]] = None,
    ) -> None:
        if num_fast < 4:
            raise ValueError("fast tier needs >= 4 frames for watermarks")
        self.config = config or TppConfig()
        self.num_frames = {Tier.FAST: num_fast, Tier.SLOW: num_slow}
        self._free: Dict[Tier, List[int]] = {
            Tier.FAST: list(range(num_fast - 1, -1, -1)),
            Tier.SLOW: list(range(num_slow - 1, -1, -1)),
        }
        self.pages: Dict[int, Page] = {}
        self._next_pid = 0
        self.lru: Dict[Tier, NodeLru] = {
            Tier.FAST: NodeLru(Tier.FAST),
            Tier.SLOW: NodeLru(Tier.SLOW),
        }
        self.vmstat = VmStat()
        self.step = 0
        # Data-plane hooks: called with (pid, src_tier, src_frame, dst_tier,
        # dst_frame) so the engine can mirror the copy in device buffers.
        self.on_migrate = on_migrate
        self.on_evict = on_evict
        # The tiering control plane (repro_torch.core.control): every
        # allocate/demote/promote decision point and lifecycle event
        # dispatches through it.  NULL_CONTROL keeps the disabled path
        # bit-identical to a control-free pool; repro.qos provides
        # telemetry (TenantAccounting), arbitration (QosArbiter) and
        # SLO feedback (SlowdownController) implementations.
        self.control: TieringControl = NULL_CONTROL
        self.wm_min, self.wm_alloc, self.wm_demote = self.config.frames(num_fast)
        # Host-local fast-tier budget (fleet control plane); defaults to
        # the physical capacity, i.e. no reservation.
        self.fast_budget = num_fast
        # Runtime invariant sanitizer (TIERSAN_LEVEL=conservation|full);
        # None when disabled — zero overhead on the interval path.
        self.tiersan = tiersan_from_env()

    # ------------------------------------------------------------------ #
    # frame accounting
    # ------------------------------------------------------------------ #
    def free_frames(self, tier: Tier) -> int:
        return len(self._free[tier])

    def used_frames(self, tier: Tier) -> int:
        return self.num_frames[tier] - len(self._free[tier])

    def under_demote_watermark(self) -> bool:
        """True when background reclaim should run (§5.2)."""
        return self.free_frames(Tier.FAST) < self.wm_demote

    def under_alloc_watermark(self) -> bool:
        return self.free_frames(Tier.FAST) < self.wm_alloc

    def under_min_watermark(self) -> bool:
        return self.free_frames(Tier.FAST) <= self.wm_min

    def set_fast_budget(self, budget: int) -> None:
        """Apply a fast-tier budget push-down (fleet coordinator).

        Same semantics as ``VectorPagePool.set_fast_budget`` — the
        budget lands as a watermark update reserving the frames beyond
        it, and is forwarded to the attached control so a quota-keeping
        arbiter re-divides its tenant shares over the new capacity.
        """
        self.wm_min, self.wm_alloc, self.wm_demote = (
            self.config.frames_for_budget(self.num_frames[Tier.FAST], budget)
        )
        self.fast_budget = int(budget)
        self.control.set_fast_budget(budget)

    # ------------------------------------------------------------------ #
    # allocation (§5.2, §5.4)
    # ------------------------------------------------------------------ #
    def allocate(
        self,
        page_type: PageType,
        pinned: bool = False,
        prefer: Optional[Tier] = None,
        tenant: int = -1,
    ) -> Page:
        """Allocate a logical page and back it with a frame.

        Placement policy (paper):
          * default — fast-first, overflow to slow when fast is at its
            min watermark (default Linux / TPP behaviour);
          * ``file_to_slow`` (§5.4) — FILE pages slow-first, overflow fast;
          * ``prefer`` overrides (used by tests / the ideal baseline);
          * a steering control (``control.steers_allocation``) may
            replace the preference per request (tenant-aware §5.4
            generalization) — watermark enforcement below is unchanged,
            so steering can never violate watermarks.

        ``tenant`` attributes the page for the control plane (−1 =
        untracked).
        """
        if self.config.file_to_slow and page_type == PageType.FILE:
            default = Tier.SLOW if prefer is None else prefer
        else:
            default = Tier.FAST if prefer is None else prefer
        first = default
        if self.control.steers_allocation:
            first = self.control.steer_allocation(AllocRequest(
                page_type=page_type, tenant=tenant, pinned=pinned,
                prefer=prefer, default=default,
            ))
            if first != default:
                self.vmstat.pgalloc_steered += 1
        tier_order: Tuple[Tier, ...] = (
            first, Tier.SLOW if first == Tier.FAST else Tier.FAST
        )

        if self.under_alloc_watermark():
            self.vmstat.pgalloc_stall += 1

        tier = None
        for t in tier_order:
            if t == Tier.FAST:
                # Allocations may not dip below the min watermark; the
                # reserve is what promotions and bursts draw on.
                if self.free_frames(t) > self.wm_min:
                    tier = t
                    break
            elif self.free_frames(t) > 0:
                tier = t
                break
        if tier is None:
            # Both tiers exhausted: hard OOM for the caller to handle
            # (engine responds by evicting victim pages first).
            raise MemoryError("page pool exhausted on both tiers")

        frame = self._free[tier].pop()
        pid = self._next_pid
        self._next_pid += 1
        flags = PageFlags.NONE
        if pinned:
            flags |= PageFlags.UNEVICTABLE
        # Kernel-faithful: new pages start on the *inactive* list; their
        # first re-touch sets ACCESSED, the second activates (two-touch).
        page = Page(
            pid=pid,
            page_type=page_type,
            tier=tier,
            frame=frame,
            flags=flags,
            birth_step=self.step,
            last_touch_step=self.step,
        )
        self.pages[pid] = page
        self.lru[tier].insert(pid, page_type, active=False)
        if tier == Tier.FAST:
            self.vmstat.pgalloc_fast += 1
        else:
            self.vmstat.pgalloc_slow += 1
        self.control.note_alloc(pid, tenant, int(tier))
        return page

    def free(self, pid: int) -> None:
        page = self.pages.pop(pid)
        self.lru[page.tier].discard(pid, page.page_type)
        self._free[page.tier].append(page.frame)
        self.vmstat.pgfree += 1
        self.control.note_free(pid, int(page.tier))

    # ------------------------------------------------------------------ #
    # access path
    # ------------------------------------------------------------------ #
    def touch(self, pid: int) -> Tier:
        """Record one access to a page; returns the tier that served it.

        Faithful to mapped-page semantics: a CPU load/store only sets the
        hardware accessed bit — **no LRU movement**.  Pages change lists
        only when a scan harvests the bit (``scan_reclaim_candidates`` /
        ``age_active``) or via the promotion fault path (TPP Fig. 13).
        The paper depends on exactly this: *"if a memory node is not
        under pressure and reclamation does not kick in, pages in the
        inactive LRU do not automatically move to the active LRU"*.
        """
        page = self.pages[pid]
        page.last_touch_step = self.step
        page.touch_count += 1
        page.history |= 1
        if page.tier == Tier.FAST:
            self.vmstat.access_fast += 1
        else:
            self.vmstat.access_slow += 1
        page.flags |= PageFlags.ACCESSED
        return page.tier

    def touch_many(self, pids: Sequence[int]) -> np.ndarray:
        """Batched :meth:`touch`; returns the serving tier per page."""
        return np.fromiter(
            (int(self.touch(int(p))) for p in pids), np.int8, count=len(pids)
        )

    def _activate(self, page: Page) -> None:
        node = self.lru[page.tier]
        node.list_for(page.page_type, False).remove(page.pid)
        node.list_for(page.page_type, True).add_head(page.pid)
        page.flags |= PageFlags.ACTIVE
        page.flags &= ~PageFlags.ACCESSED
        self.vmstat.pgactivate += 1

    def activate(self, pid: int) -> None:
        """Move an inactive page to its tier's active list (public API).

        This is the kernel's ``activate_page`` — policies use it for the
        promotion-hysteresis path (Fig. 13 step ②) instead of reaching
        into the LRU internals.
        """
        self._activate(self.pages[pid])

    def deactivate(self, page: Page) -> None:
        node = self.lru[page.tier]
        node.list_for(page.page_type, True).remove(page.pid)
        node.list_for(page.page_type, False).add_head(page.pid)
        page.flags &= ~(PageFlags.ACTIVE | PageFlags.ACCESSED)
        self.vmstat.pgdeactivate += 1

    # ------------------------------------------------------------------ #
    # aging (kernel active/inactive balancing)
    # ------------------------------------------------------------------ #
    def age_active(self, tier: Tier, inactive_ratio: float = 1.0) -> int:
        """Deactivate cold active pages until inactive ≥ ratio × active.

        The ACCESSED bit is the age test: referenced active pages get it
        cleared (second chance), unreferenced ones are deactivated.
        """
        node = self.lru[tier]
        moved = 0
        for pt in PageType:
            act = node.list_for(pt, True)
            inact = node.list_for(pt, False)
            scans = len(act)
            while len(inact) < inactive_ratio * len(act) and scans > 0:
                scans -= 1
                pid = act.peek_oldest()
                if pid is None:
                    break
                page = self.pages[pid]
                self.vmstat.pgscan += 1
                if page.accessed:
                    page.flags &= ~PageFlags.ACCESSED
                    act.rotate(pid)
                else:
                    self.deactivate(page)
                    moved += 1
        return moved

    def end_interval(self) -> None:
        """Close an access interval: shift history bitmaps (Chameleon §3)
        and tick the control plane (quota re-division, token refill)."""
        for page in self.pages.values():
            page.history = (page.history << 1) & ((1 << 64) - 1)
        self.control.note_interval()
        if self.tiersan is not None:
            self.tiersan.on_interval(self)

    # ------------------------------------------------------------------ #
    # migration (§5.1) — demote / promote / evict
    # ------------------------------------------------------------------ #
    def _move(self, page: Page, dst_tier: Tier) -> bool:
        if self.free_frames(dst_tier) == 0:
            return False
        src_tier, src_frame = page.tier, page.frame
        dst_frame = self._free[dst_tier].pop()
        if self.on_migrate is not None:
            self.on_migrate(page.pid, src_tier, src_frame, dst_tier, dst_frame)
        self._free[src_tier].append(src_frame)
        self.lru[src_tier].discard(page.pid, page.page_type)
        page.tier = dst_tier
        page.frame = dst_frame
        return True

    def demote_page(self, pid: int) -> DemoteFail:
        """Migrate a page fast→slow (asynchronous reclaim path, §5.1)."""
        page = self.pages[pid]
        assert page.tier == Tier.FAST, "demotion source must be FAST"
        if page.pinned:
            self.vmstat.demote_fail(DemoteFail.PINNED)
            return DemoteFail.PINNED
        if not self._move(page, Tier.SLOW):
            self.vmstat.demote_fail(DemoteFail.SLOW_FULL)
            return DemoteFail.SLOW_FULL
        page.flags |= PageFlags.DEMOTED
        # Demoted pages land on the slow node's inactive list and must
        # re-prove hotness through the two-touch filter before promotion.
        page.flags &= ~(PageFlags.ACTIVE | PageFlags.ACCESSED)
        self.lru[Tier.SLOW].insert(pid, page.page_type, active=False)
        self.vmstat.demote_success(page.page_type == PageType.ANON)
        self.control.note_demote(pid)
        return DemoteFail.NONE

    def promote_page(self, pid: int) -> PromoteFail:
        """Migrate a page slow→fast (promotion path, §5.3).

        Per the paper, promotion *ignores the allocation watermark* — it
        may draw the fast tier below ``wm_alloc``; the resulting pressure
        re-triggers background demotion.
        """
        page = self.pages[pid]
        assert page.tier == Tier.SLOW, "promotion source must be SLOW"
        if page.pinned:
            self.vmstat.promote_fail(PromoteFail.PINNED)
            return PromoteFail.PINNED
        if not self.control.admit_promotions((pid,))[0]:
            self.vmstat.promote_fail(PromoteFail.QOS)
            return PromoteFail.QOS
        if not self._move(page, Tier.FAST):
            self.control.refund_promotion(pid)
            self.vmstat.promote_fail(PromoteFail.TARGET_LOW_MEM)
            return PromoteFail.TARGET_LOW_MEM
        page.flags &= ~PageFlags.DEMOTED  # PG_demoted cleared on promotion
        # Promoted pages were proven hot → enter the active list.
        page.flags |= PageFlags.ACTIVE
        self.lru[Tier.FAST].insert(pid, page.page_type, active=True)
        self.vmstat.promote_success(page.page_type == PageType.ANON)
        self.control.note_promote(pid)
        return PromoteFail.NONE

    def demote_pages(self, pids: Sequence[int]) -> Tuple[int, List[int], int]:
        """Apply a batch of demotions; ``(n_demoted, overflow_pids, n_failed)``.

        Exactly equivalent to calling :meth:`demote_page` per pid in
        order: successes while the slow tier has frames, ``SLOW_FULL``
        failures (counted in vmstat here) returned as ``overflow_pids``
        for the caller's per-page fallback (evict), and other failures
        (pinned) tallied in ``n_failed``.  The vectorized pool overrides
        this with an array-batched implementation.
        """
        return demote_pages_sequential(self, pids)

    def promote_pages(self, pids: Sequence[int]) -> Tuple[int, int]:
        """Apply a batch of promotions; ``(n_promoted, n_failed)``.

        Exactly equivalent to calling :meth:`promote_page` per pid in
        order — admission (``control.admit_promotions``), migration and
        failure accounting sequence identically.  The vectorized pool
        overrides this with an array-batched implementation that makes
        one admission call for the whole batch.
        """
        return promote_pages_sequential(self, pids)

    def evict_page(self, pid: int) -> None:
        """Reclaim a page entirely (swap-out analogue; §5.1 fallback)."""
        page = self.pages[pid]
        if self.on_evict is not None:
            self.on_evict(pid)
        self.free(pid)
        self.vmstat.pswpout += 1

    # ------------------------------------------------------------------ #
    # reclaim-candidate scan (inactive tail, second chance)
    # ------------------------------------------------------------------ #
    def scan_reclaim_candidates(self, tier: Tier, nr_to_scan: int) -> List[int]:
        """Select up to ``nr_to_scan`` cold pages from the inactive tails.

        Paper §5.1: *"along with inactive file pages, we scan inactive
        anon pages for reclamation candidate selection"* — both types are
        scanned, proportionally to list size (kernel scan balance).
        The control plane may reorder the result (e.g. over-quota
        tenants demote first) — a pure reorder of the scan output,
        identical across engines.
        """
        return self.control.order_demotion_victims(
            self._scan_reclaim_candidates(tier, nr_to_scan)
        )

    def _scan_reclaim_candidates(self, tier: Tier, nr_to_scan: int) -> List[int]:
        node = self.lru[tier]
        out: List[int] = []
        sizes = {pt: node.n_inactive(pt) for pt in PageType}
        total = sum(sizes.values())
        if total == 0:
            return out
        seen: set = set()
        for pt in PageType:
            share = max(1, round(nr_to_scan * sizes[pt] / total)) if sizes[pt] else 0
            inact = node.list_for(pt, False)
            scanned = 0
            rotations = 0
            while scanned < share and len(inact) > 0 and rotations < len(inact) + share:
                pid = inact.peek_oldest()
                if pid in seen:
                    break  # wrapped around the list — stop this type
                page = self.pages[pid]
                self.vmstat.pgscan += 1
                rotations += 1
                if page.pinned:
                    inact.rotate(pid)
                    seen.add(pid)
                    continue
                if page.accessed:
                    # referenced mapped page found by the scan → activate
                    # (kernel page_check_references → PAGEREF_ACTIVATE)
                    self._activate(page)
                    continue
                out.append(pid)
                seen.add(pid)
                inact.rotate(pid)  # keep position; demotion removes it
                scanned += 1
                if len(out) >= nr_to_scan:
                    return out
        return out

    # ------------------------------------------------------------------ #
    # accessor surface (repro_torch.core.policy.PlacementPool)
    # ------------------------------------------------------------------ #
    def has_page(self, pid: int) -> bool:
        return pid in self.pages

    def live_mask(self, pids: Sequence[int]) -> np.ndarray:
        return np.fromiter(
            (int(p) in self.pages for p in pids), bool, count=len(pids)
        )

    def tier_of(self, pid: int) -> Tier:
        return self.pages[pid].tier

    def is_slow_live(self, pid: int) -> bool:
        """Live and slow-tier — the promotion loops' per-candidate gate."""
        page = self.pages.get(pid)
        return page is not None and page.tier == Tier.SLOW

    def ptype_of(self, pid: int) -> PageType:
        return self.pages[pid].page_type

    def is_active(self, pid: int) -> bool:
        return self.pages[pid].active

    def is_demoted(self, pid: int) -> bool:
        return self.pages[pid].demoted

    def is_pinned(self, pid: int) -> bool:
        return self.pages[pid].pinned

    def touch_count_of(self, pid: int) -> int:
        return self.pages[pid].touch_count

    def demotion_victims(self, limit: int) -> List[int]:
        """Coldest unpinned fast-tier pages by (touch_count, recency).

        Frequency-ranked victim selection (AutoTiering's demotion rule).
        Stable order: ties break by allocation order (ascending pid).
        """
        victims = sorted(
            (p for p in self.pages.values()
             if p.tier == Tier.FAST and not p.pinned),
            key=lambda p: (p.touch_count, p.last_touch_step),
        )[:limit]
        return self.control.order_demotion_victims([p.pid for p in victims])

    def fallback_slow_victim(self) -> Optional[int]:
        """Any unpinned slow page (OOM last resort), oldest pid first."""
        for p in self.pages.values():
            if p.tier == Tier.SLOW and not p.pinned:
                return p.pid
        return None

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    def pages_in_tier(self, tier: Tier) -> List[int]:
        return [p.pid for p in self.pages.values() if p.tier == tier]

    def occupancy(self) -> Dict[str, float]:
        return {
            "fast_used": self.used_frames(Tier.FAST),
            "fast_free": self.free_frames(Tier.FAST),
            "slow_used": self.used_frames(Tier.SLOW),
            "slow_free": self.free_frames(Tier.SLOW),
        }

    def check_invariants(self) -> None:
        """Validate pool consistency (used by property tests)."""
        seen_frames = {Tier.FAST: set(), Tier.SLOW: set()}
        for page in self.pages.values():
            assert page.frame not in seen_frames[page.tier], (
                f"frame {page.frame} double-mapped on {page.tier}"
            )
            seen_frames[page.tier].add(page.frame)
            in_active = page.pid in self.lru[page.tier].list_for(
                page.page_type, True
            )
            in_inactive = page.pid in self.lru[page.tier].list_for(
                page.page_type, False
            )
            assert in_active != in_inactive, (
                f"page {page.pid} LRU membership broken "
                f"(active={in_active} inactive={in_inactive})"
            )
            assert page.active == in_active, (
                f"page {page.pid} ACTIVE flag {page.active} but list {in_active}"
            )
        for tier in (Tier.FAST, Tier.SLOW):
            free = set(self._free[tier])
            assert len(free) == len(self._free[tier]), "free list duplicates"
            assert not (free & seen_frames[tier]), "frame both free and mapped"
            assert len(free) + len(seen_frames[tier]) == self.num_frames[tier]


def demote_pages_sequential(pool, pids: Sequence[int]) -> Tuple[int, List[int], int]:
    """Per-pid demotion sequence shared by both pool engines.

    This loop *is* the batch-demotion semantics: the vectorized pool
    falls back to it whenever exactness demands per-page interleaving
    (migration hooks, pinned pages).
    """
    n_ok = 0
    n_failed = 0
    overflow: List[int] = []
    for pid in pids:
        res = pool.demote_page(pid)
        if res == DemoteFail.NONE:
            n_ok += 1
        elif res == DemoteFail.SLOW_FULL:
            overflow.append(pid)
        else:
            n_failed += 1
    return n_ok, overflow, n_failed


def promote_pages_sequential(pool, pids: Sequence[int]) -> Tuple[int, int]:
    """Per-pid promotion sequence shared by both pool engines.

    This loop *is* the batch-promotion semantics; the vectorized pool
    falls back to it whenever exactness demands per-page interleaving
    (migration hooks, pinned pages, fast-tier frame exhaustion
    mid-batch).
    """
    n_ok = 0
    n_failed = 0
    for pid in pids:
        if pool.promote_page(pid) == PromoteFail.NONE:
            n_ok += 1
        else:
            n_failed += 1
    return n_ok, n_failed
