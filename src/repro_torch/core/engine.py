"""Struct-of-arrays vectorized placement engine.

:class:`VectorPagePool` reimplements the reference
:class:`~repro_torch.core.page_pool.PagePool` semantics over parallel NumPy
arrays (DESIGN.md §4):

* the **logical page table** is eight parallel arrays indexed by pid —
  tier, frame, type, flags, birth/last-touch step, touch count and the
  64-bit access-history bitmap;
* the per-tier **LRU lists** are intrusive doubly-linked lists stored in
  two pid-indexed arrays (``newer``/``older``) with one head/tail pair
  per (tier × page-type × active) list — O(1) insert/remove/rotate with
  no per-page Python objects;
* **free frames** are array-backed stacks, so a batch of k allocations
  pops k frames with one slice;
* the hot paths are **batched**: :meth:`touch_many` records a whole
  step's accesses with fancy indexing, :meth:`try_allocate_many` places
  a run of same-type allocations with closed-form watermark math, and
  :meth:`end_interval` shifts every history bitmap in one vector op.

Semantics are bit-for-bit identical to the reference pool: the same
``VmStat`` counter trajectory, the same LRU visit order in the scan
paths, the same watermark decisions.  ``tests/test_torch_sim.py``
holds this copy to both JAX pools for every policy; the reference ``PagePool`` remains the
executable specification.

A copy of ``repro.core.engine`` with the same behaviour; the port keeps its own
so that it imports nothing of ``repro``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.tiersan import tiersan_from_env
from repro_torch.core.control import NULL_CONTROL, AllocRequest, TieringControl
from repro_torch.core.types import (
    DemoteFail,
    PageFlags,
    PageType,
    PromoteFail,
    Tier,
    TppConfig,
)
from repro_torch.core.vmstat import VmStat

_ONE = np.uint64(1)
# Plain-int flag constants: IntFlag arithmetic routes through enum
# __rand__/__call__ (isinstance checks + object construction) which is
# 10-20× a plain int op — far too slow for the per-page hot paths.
_ACTIVE = int(PageFlags.ACTIVE)
_ACCESSED = int(PageFlags.ACCESSED)
_DEMOTED = int(PageFlags.DEMOTED)
_UNEVICTABLE = int(PageFlags.UNEVICTABLE)
_NOT_ACTIVE_NOT_ACCESSED = 0xFF & ~(_ACTIVE | _ACCESSED)
_NOT_ACCESSED = 0xFF & ~_ACCESSED
_NOT_DEMOTED = 0xFF & ~_DEMOTED
_NO_TIER = np.int8(int(Tier.NONE))

#: The available pool engines (single source of truth for simulator & CLI).
ENGINES = ("reference", "vectorized")


class PageView:
    """Lightweight read view of one page table row (``Page`` look-alike)."""

    __slots__ = ("_pool", "pid")

    def __init__(self, pool: "VectorPagePool", pid: int) -> None:
        self._pool = pool
        self.pid = pid

    @property
    def tier(self) -> Tier:
        return Tier(int(self._pool._tier[self.pid]))

    @property
    def frame(self) -> int:
        return int(self._pool._frame[self.pid])

    @property
    def page_type(self) -> PageType:
        return PageType(int(self._pool._ptype[self.pid]))

    @property
    def flags(self) -> PageFlags:
        return PageFlags(int(self._pool._flags[self.pid]))

    @property
    def birth_step(self) -> int:
        return int(self._pool._birth[self.pid])

    @property
    def last_touch_step(self) -> int:
        return int(self._pool._last_touch[self.pid])

    @property
    def touch_count(self) -> int:
        return int(self._pool._touch_count[self.pid])

    @property
    def history(self) -> int:
        return int(self._pool._history[self.pid])

    @property
    def active(self) -> bool:
        return bool(self._pool._flags[self.pid] & _ACTIVE)

    @property
    def accessed(self) -> bool:
        return bool(self._pool._flags[self.pid] & _ACCESSED)

    @property
    def demoted(self) -> bool:
        return bool(self._pool._flags[self.pid] & _DEMOTED)

    @property
    def pinned(self) -> bool:
        return bool(self._pool._flags[self.pid] & _UNEVICTABLE)


class _FrameStack:
    """Array-backed free-frame stack with the reference pop/push order."""

    __slots__ = ("_arr", "_top")

    def __init__(self, num_frames: int) -> None:
        # Same initial order as the reference free list: frame 0 on top.
        self._arr = np.arange(num_frames - 1, -1, -1, dtype=np.int64)
        self._top = num_frames

    def __len__(self) -> int:
        return self._top

    def pop(self) -> int:
        if self._top <= 0:
            raise IndexError("pop from empty frame stack")
        self._top -= 1
        return int(self._arr[self._top])

    def pop_many(self, k: int) -> np.ndarray:
        """k frames in the order k successive pops would return them."""
        if not 0 <= k <= self._top:
            # A negative slice start would silently wrap and hand out
            # frames below the stack base (and leave _top negative).
            raise ValueError(
                f"pop_many({k}) with only {self._top} free frames"
            )
        if k == 0:
            return np.empty(0, np.int64)
        out = self._arr[self._top - k : self._top][::-1].copy()
        self._top -= k
        return out

    def push(self, frame: int) -> None:
        if self._top == len(self._arr):
            self._arr = np.resize(self._arr, max(8, 2 * len(self._arr)))
        self._arr[self._top] = frame
        self._top += 1

    def push_many(self, frames: np.ndarray) -> None:
        if len(frames) == 0:
            return
        need = self._top + len(frames)
        if need > len(self._arr):
            self._arr = np.resize(self._arr, max(need, 2 * len(self._arr)))
        self._arr[self._top : need] = frames
        self._top = need


def _list_id(tier: int, ptype: int, active: bool) -> int:
    return int(tier) * 4 + int(ptype) * 2 + int(active)


class VectorPagePool:
    """Two-tier pool over parallel arrays — PagePool-equivalent semantics."""

    INITIAL_CAPACITY = 1024

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
        self._stacks = {Tier.FAST: _FrameStack(num_fast), Tier.SLOW: _FrameStack(num_slow)}
        self.vmstat = VmStat()
        self.step = 0
        self.on_migrate = on_migrate
        self.on_evict = on_evict
        # The tiering control plane (repro_torch.core.control) — same uniform
        # dispatch surface as the reference pool; NULL_CONTROL keeps the
        # disabled path bit-identical to a control-free pool.
        self.control: TieringControl = NULL_CONTROL
        self.wm_min, self.wm_alloc, self.wm_demote = self.config.frames(num_fast)
        # Host-local fast-tier budget (fleet control plane); defaults to
        # the physical capacity, i.e. no reservation.
        self.fast_budget = num_fast
        # Runtime invariant sanitizer (TIERSAN_LEVEL=conservation|full);
        # None when disabled — zero overhead on the interval path.
        self.tiersan = tiersan_from_env()

        cap = self.INITIAL_CAPACITY
        self._next_pid = 0
        self._tier = np.full(cap, _NO_TIER, np.int8)
        self._frame = np.full(cap, -1, np.int64)
        self._ptype = np.zeros(cap, np.int8)
        self._flags = np.zeros(cap, np.uint8)
        self._birth = np.zeros(cap, np.int64)
        self._last_touch = np.zeros(cap, np.int64)
        self._touch_count = np.zeros(cap, np.int64)
        self._history = np.zeros(cap, np.uint64)
        self._live = np.zeros(cap, bool)
        # Intrusive LRU links: one (newer, older) pair per pid; each live
        # page sits in exactly one of the 8 (tier, type, active) lists.
        # Plain Python lists: the links are only ever read/written one
        # element at a time, where list indexing is ~5x numpy scalar
        # indexing.  ``_lid`` caches the page's current list id so LRU
        # transitions never re-derive it from tier/type/flags.
        self._newer = [-1] * cap
        self._older = [-1] * cap
        self._lid = [0] * cap
        self._heads = [-1] * 8  # MRU end
        self._tails = [-1] * 8  # oldest end
        self._lens = [0] * 8

    # ------------------------------------------------------------------ #
    # capacity
    # ------------------------------------------------------------------ #
    def _ensure_capacity(self, n_new: int) -> None:
        need = self._next_pid + n_new
        cap = len(self._tier)
        if need <= cap:
            return
        new_cap = max(need, 2 * cap)

        def grow(arr: np.ndarray, fill) -> np.ndarray:
            out = np.full(new_cap, fill, arr.dtype)
            out[:cap] = arr
            return out

        self._tier = grow(self._tier, _NO_TIER)
        self._frame = grow(self._frame, -1)
        self._ptype = grow(self._ptype, 0)
        self._flags = grow(self._flags, 0)
        self._birth = grow(self._birth, 0)
        self._last_touch = grow(self._last_touch, 0)
        self._touch_count = grow(self._touch_count, 0)
        self._history = grow(self._history, 0)
        self._live = grow(self._live, False)
        pad = new_cap - cap
        self._newer.extend([-1] * pad)
        self._older.extend([-1] * pad)
        self._lid.extend([0] * pad)

    # ------------------------------------------------------------------ #
    # intrusive LRU primitives
    # ------------------------------------------------------------------ #
    def _lru_add_head(self, lid: int, pid: int) -> None:
        head = self._heads[lid]
        self._older[pid] = head
        self._newer[pid] = -1
        self._lid[pid] = lid
        if head != -1:
            self._newer[head] = pid
        else:
            self._tails[lid] = pid
        self._heads[lid] = pid
        self._lens[lid] += 1

    def _lru_add_head_batch(self, lid: int, pids: np.ndarray) -> None:
        """Insert pids as k successive add_head calls (last pid = MRU)."""
        plist = pids.tolist()
        if not plist:
            return
        newer, older, lids = self._newer, self._older, self._lid
        prev = self._heads[lid]
        if prev == -1:
            self._tails[lid] = plist[0]
        for pid in plist:
            older[pid] = prev
            lids[pid] = lid
            if prev != -1:
                newer[prev] = pid
            prev = pid
        newer[prev] = -1
        self._heads[lid] = prev
        self._lens[lid] += len(plist)

    def _lru_remove(self, lid: int, pid: int) -> None:
        newer = self._newer[pid]
        older = self._older[pid]
        if newer != -1:
            self._older[newer] = older
        else:
            self._heads[lid] = older
        if older != -1:
            self._newer[older] = newer
        else:
            self._tails[lid] = newer
        self._newer[pid] = -1
        self._older[pid] = -1
        self._lens[lid] -= 1

    def _lru_rotate(self, lid: int, pid: int) -> None:
        if self._heads[lid] == pid:
            return
        self._lru_remove(lid, pid)
        self._lru_add_head(lid, pid)

    def _lid_of(self, pid: int) -> int:
        return self._lid[pid]

    # ------------------------------------------------------------------ #
    # frame accounting
    # ------------------------------------------------------------------ #
    def free_frames(self, tier: Tier) -> int:
        return len(self._stacks[tier])

    def used_frames(self, tier: Tier) -> int:
        return self.num_frames[tier] - len(self._stacks[tier])

    def under_demote_watermark(self) -> bool:
        return self.free_frames(Tier.FAST) < self.wm_demote

    def under_alloc_watermark(self) -> bool:
        return self.free_frames(Tier.FAST) < self.wm_alloc

    def under_min_watermark(self) -> bool:
        return self.free_frames(Tier.FAST) <= self.wm_min

    def set_fast_budget(self, budget: int) -> None:
        """Apply a fast-tier budget push-down (fleet coordinator).

        The budget lands as a watermark update — ``num_fast - budget``
        frames become a standing reservation above the usual min/alloc/
        demote levels, so background reclaim shrinks (or regrows) the
        effective fast tier to ``budget`` frames over the next
        intervals — and is forwarded to the attached control so a
        quota-keeping arbiter re-divides its tenant shares over the new
        capacity.  ``budget == num_fast`` restores the unbudgeted
        watermarks exactly.
        """
        self.wm_min, self.wm_alloc, self.wm_demote = (
            self.config.frames_for_budget(self.num_frames[Tier.FAST], budget)
        )
        self.fast_budget = int(budget)
        self.control.set_fast_budget(budget)

    # ------------------------------------------------------------------ #
    # allocation
    # ------------------------------------------------------------------ #
    def allocate(
        self,
        page_type: PageType,
        pinned: bool = False,
        prefer: Optional[Tier] = None,
        tenant: int = -1,
    ) -> PageView:
        """Scalar allocation — mirrors ``PagePool.allocate`` exactly."""
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
                if self.free_frames(t) > self.wm_min:
                    tier = t
                    break
            elif self.free_frames(t) > 0:
                tier = t
                break
        if tier is None:
            raise MemoryError("page pool exhausted on both tiers")

        frame = self._stacks[tier].pop()
        self._ensure_capacity(1)
        pid = self._next_pid
        self._next_pid += 1
        self._tier[pid] = np.int8(int(tier))
        self._frame[pid] = frame
        self._ptype[pid] = np.int8(int(page_type))
        self._flags[pid] = _UNEVICTABLE if pinned else 0
        self._birth[pid] = self.step
        self._last_touch[pid] = self.step
        self._touch_count[pid] = 0
        self._history[pid] = 0
        self._live[pid] = True
        self._lru_add_head(_list_id(int(tier), int(page_type), False), pid)
        if tier == Tier.FAST:
            self.vmstat.pgalloc_fast += 1
        else:
            self.vmstat.pgalloc_slow += 1
        self.control.note_alloc(pid, tenant, int(tier))
        return PageView(self, pid)

    def try_allocate_many(
        self, page_type: PageType, n: int, tenants=None
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Place ``n`` same-type pages as one batch; ``(pids, tiers)``.

        Equivalent to ``n`` successive :meth:`allocate` calls — the tier
        split, per-call ``pgalloc_stall`` accounting, and LRU/frames are
        computed in closed form.  Returns ``None`` when any of those
        calls would raise ``MemoryError`` (caller falls back to the
        scalar path, which owns the eviction-retry logic) **or** when a
        steering control is attached — per-allocation steering decisions
        depend on residency updated by every placement, so they must
        sequence through the scalar path exactly like the reference
        engine.

        ``tenants`` is a scalar tenant id or per-allocation array for
        the control plane's ledger (``note_alloc_many``).
        """
        if self.control.steers_allocation:
            return None
        if n == 0:
            return np.empty(0, np.int64), np.empty(0, np.int8)
        f0 = self.free_frames(Tier.FAST)
        s0 = self.free_frames(Tier.SLOW)
        slow_first = self.config.file_to_slow and page_type == PageType.FILE
        fast_avail = max(0, f0 - self.wm_min)
        if slow_first:
            k_slow = min(n, s0)
            k_fast = min(n - k_slow, fast_avail)
        else:
            k_fast = min(n, fast_avail)
            k_slow = min(n - k_fast, s0)
        if k_fast + k_slow < n:
            return None

        # pgalloc_stall: per call, `free_fast < wm_alloc` checked before
        # the allocation.  free_fast only moves during the fast phase
        # (one frame per fast alloc), so the count is closed-form.
        A = self.wm_alloc
        if slow_first:
            stalls = k_slow if f0 < A else 0
            stalls += max(0, k_fast - max(0, min(k_fast, f0 - A + 1)))
        else:
            stalls = max(0, k_fast - max(0, min(k_fast, f0 - A + 1)))
            stalls += (n - k_fast) if (f0 - k_fast) < A else 0
        self.vmstat.pgalloc_stall += stalls

        self._ensure_capacity(n)
        pids = np.arange(self._next_pid, self._next_pid + n, dtype=np.int64)
        self._next_pid += n
        tiers = np.empty(n, np.int8)
        if slow_first:
            tiers[:k_slow] = np.int8(int(Tier.SLOW))
            tiers[k_slow:] = np.int8(int(Tier.FAST))
            slow_pids, fast_pids = pids[:k_slow], pids[k_slow:]
        else:
            tiers[:k_fast] = np.int8(int(Tier.FAST))
            tiers[k_fast:] = np.int8(int(Tier.SLOW))
            fast_pids, slow_pids = pids[:k_fast], pids[k_fast:]

        self._tier[pids] = tiers
        if k_fast:
            self._frame[fast_pids] = self._stacks[Tier.FAST].pop_many(k_fast)
        if k_slow:
            self._frame[slow_pids] = self._stacks[Tier.SLOW].pop_many(k_slow)
        self._ptype[pids] = np.int8(int(page_type))
        self._flags[pids] = np.uint8(0)
        self._birth[pids] = self.step
        self._last_touch[pids] = self.step
        self._touch_count[pids] = 0
        self._history[pids] = 0
        self._live[pids] = True
        if k_fast:
            self._lru_add_head_batch(
                _list_id(int(Tier.FAST), int(page_type), False), fast_pids
            )
        if k_slow:
            self._lru_add_head_batch(
                _list_id(int(Tier.SLOW), int(page_type), False), slow_pids
            )
        self.vmstat.pgalloc_fast += k_fast
        self.vmstat.pgalloc_slow += k_slow
        self.control.note_alloc_many(
            pids, tenants if tenants is not None else -1, tiers
        )
        return pids, tiers

    def free(self, pid: int) -> None:
        tier = int(self._tier[pid])
        self._lru_remove(self._lid[pid], pid)
        self._stacks[Tier(tier)].push(int(self._frame[pid]))
        self._live[pid] = False
        self._tier[pid] = _NO_TIER
        self.vmstat.pgfree += 1
        self.control.note_free(pid, tier)

    # ------------------------------------------------------------------ #
    # access path
    # ------------------------------------------------------------------ #
    def touch(self, pid: int) -> Tier:
        self._last_touch[pid] = self.step
        self._touch_count[pid] += 1
        self._history[pid] |= _ONE
        tier = self._tier[pid].item()
        if tier == 0:  # Tier.FAST
            self.vmstat.access_fast += 1
        else:
            self.vmstat.access_slow += 1
        self._flags[pid] = self._flags[pid].item() | _ACCESSED
        return Tier(tier)

    def touch_many(self, pids: np.ndarray) -> np.ndarray:
        """Batched touch — one access per element (duplicates allowed)."""
        if len(pids) == 0:
            return np.empty(0, np.int8)
        self._last_touch[pids] = self.step
        np.add.at(self._touch_count, pids, 1)
        self._history[pids] |= _ONE
        self._flags[pids] |= _ACCESSED
        tiers = self._tier[pids]
        n_fast = int(np.count_nonzero(tiers == np.int8(int(Tier.FAST))))
        self.vmstat.access_fast += n_fast
        self.vmstat.access_slow += len(pids) - n_fast
        return tiers

    def activate(self, pid: int) -> None:
        """Inactive → active (public API; kernel ``activate_page``)."""
        lid = self._lid[pid]  # inactive list: even lid
        self._lru_remove(lid, pid)
        flags = self._flags[pid].item()
        self._flags[pid] = (flags | _ACTIVE) & _NOT_ACCESSED
        self._lru_add_head(lid + 1, pid)
        self.vmstat.pgactivate += 1

    def deactivate(self, pid: int) -> None:
        lid = self._lid[pid]  # active list: odd lid
        self._lru_remove(lid, pid)
        self._flags[pid] = self._flags[pid].item() & _NOT_ACTIVE_NOT_ACCESSED
        self._lru_add_head(lid - 1, pid)
        self.vmstat.pgdeactivate += 1

    # ------------------------------------------------------------------ #
    # aging
    # ------------------------------------------------------------------ #
    def age_active(self, tier: Tier, inactive_ratio: float = 1.0) -> int:
        moved = 0
        vmstat = self.vmstat
        flags_arr = self._flags
        lens = self._lens
        for pt in PageType:
            lid_a = _list_id(int(tier), int(pt), True)
            lid_i = lid_a - 1
            scans = lens[lid_a]
            while lens[lid_i] < inactive_ratio * lens[lid_a] and scans > 0:
                scans -= 1
                pid = self._tails[lid_a]
                if pid == -1:
                    break
                vmstat.pgscan += 1
                flags = flags_arr[pid].item()
                if flags & _ACCESSED:
                    flags_arr[pid] = flags & _NOT_ACCESSED
                    self._lru_rotate(lid_a, pid)
                else:
                    self.deactivate(pid)
                    moved += 1
        return moved

    def end_interval(self) -> None:
        """Shift every history bitmap left one interval (vector op) and
        tick the control plane (quota re-division, token refill)."""
        np.left_shift(self._history, _ONE, out=self._history)
        self.control.note_interval()
        if self.tiersan is not None:
            self.tiersan.on_interval(self)

    # ------------------------------------------------------------------ #
    # migration
    # ------------------------------------------------------------------ #
    def _move(self, pid: int, dst_tier: Tier) -> bool:
        if len(self._stacks[dst_tier]) == 0:
            return False
        src_tier = Tier(self._tier[pid].item())
        src_frame = self._frame[pid].item()
        dst_frame = self._stacks[dst_tier].pop()
        if self.on_migrate is not None:
            self.on_migrate(pid, src_tier, src_frame, dst_tier, dst_frame)
        self._stacks[src_tier].push(src_frame)
        self._lru_remove(self._lid[pid], pid)
        self._tier[pid] = int(dst_tier)
        self._frame[pid] = dst_frame
        return True

    def demote_page(self, pid: int) -> DemoteFail:
        # repro-lint: disable=assert-host-sync (scalar-path precondition)
        assert self._tier[pid].item() == 0, "demotion source must be FAST"
        flags = self._flags[pid].item()
        if flags & _UNEVICTABLE:
            self.vmstat.demote_fail(DemoteFail.PINNED)
            return DemoteFail.PINNED
        if not self._move(pid, Tier.SLOW):
            self.vmstat.demote_fail(DemoteFail.SLOW_FULL)
            return DemoteFail.SLOW_FULL
        self._flags[pid] = (flags | _DEMOTED) & _NOT_ACTIVE_NOT_ACCESSED
        ptype = self._ptype[pid].item()
        self._lru_add_head(4 + ptype * 2, pid)  # (SLOW, ptype, inactive)
        self.vmstat.demote_success(ptype == 0)  # PageType.ANON
        self.control.note_demote(pid)
        return DemoteFail.NONE

    def promote_page(self, pid: int) -> PromoteFail:
        # repro-lint: disable=assert-host-sync (scalar-path precondition)
        assert self._tier[pid].item() == 1, "promotion source must be SLOW"
        flags = self._flags[pid].item()
        if flags & _UNEVICTABLE:
            self.vmstat.promote_fail(PromoteFail.PINNED)
            return PromoteFail.PINNED
        if not self.control.admit_promotions((pid,))[0]:
            self.vmstat.promote_fail(PromoteFail.QOS)
            return PromoteFail.QOS
        if not self._move(pid, Tier.FAST):
            self.control.refund_promotion(pid)
            self.vmstat.promote_fail(PromoteFail.TARGET_LOW_MEM)
            return PromoteFail.TARGET_LOW_MEM
        self._flags[pid] = (flags & _NOT_DEMOTED) | _ACTIVE
        ptype = self._ptype[pid].item()
        self._lru_add_head(ptype * 2 + 1, pid)  # (FAST, ptype, active)
        self.vmstat.promote_success(ptype == 0)  # PageType.ANON
        self.control.note_promote(pid)
        return PromoteFail.NONE

    def demote_pages(self, pids: Sequence[int]) -> Tuple[int, List[int], int]:
        """Array-batched demotion; ``(n_demoted, overflow_pids, n_failed)``.

        Equivalent to per-pid :meth:`demote_page` calls in order: the
        first ``free_slow`` candidates succeed, the rest are SLOW_FULL
        overflow.  Candidates are unpinned by construction (the scan and
        the frequency victim selection both filter pinned pages); if one
        slips in, fall back to the exact scalar sequence.
        """
        n = len(pids)
        if n == 0:
            return 0, [], 0
        arr = np.asarray(pids, np.int64)
        if self.on_migrate is not None or bool(
            np.any(self._flags[arr] & np.uint8(_UNEVICTABLE))
        ):
            # hooks need per-page (src, dst) frames; pinned needs the
            # per-page failure interleaving — use the shared sequence
            from repro_torch.core.page_pool import demote_pages_sequential

            return demote_pages_sequential(self, pids)
        k = min(n, len(self._stacks[Tier.SLOW]))
        ok = arr[:k]
        overflow = [int(p) for p in arr[k:]]
        if k:
            # frames: k slow pops / k fast pushes, in candidate order
            fast_frames = self._frame[ok].copy()
            self._frame[ok] = self._stacks[Tier.SLOW].pop_many(k)
            for pid in ok.tolist():  # unlink from the FAST inactive lists
                self._lru_remove(self._lid[pid], pid)
            self._stacks[Tier.FAST].push_many(fast_frames)
            self._flags[ok] = (
                self._flags[ok] | np.uint8(_DEMOTED)
            ) & np.uint8(_NOT_ACTIVE_NOT_ACCESSED)
            self._tier[ok] = np.int8(int(Tier.SLOW))
            ptypes = self._ptype[ok]
            anon_sel = ptypes == np.int8(int(PageType.ANON))
            n_anon = int(np.count_nonzero(anon_sel))
            if n_anon:
                self._lru_add_head_batch(4, ok[anon_sel])  # SLOW/ANON/inact
            if k - n_anon:
                self._lru_add_head_batch(6, ok[~anon_sel])  # SLOW/FILE/inact
            self.vmstat.demote_success(True, n_anon)
            self.vmstat.demote_success(False, k - n_anon)
            self.control.note_demote_many(ok)
        if overflow:
            self.vmstat.demote_fail(DemoteFail.SLOW_FULL, len(overflow))
        return k, overflow, 0

    def promote_pages(self, pids: Sequence[int]) -> Tuple[int, int]:
        """Array-batched promotion; ``(n_promoted, n_failed)``.

        Equivalent to per-pid :meth:`promote_page` calls in order.  The
        batch path needs (a) no per-page migration hooks, (b) no pinned
        pages (their failures interleave), and (c) enough free fast
        frames for the whole batch — then every *admitted* candidate is
        guaranteed a frame, which is exactly the assumption that makes
        one batched ``control.admit_promotions`` call sequence-exact
        (admission models provisional residency of earlier admissions).
        Anything else falls back to the shared per-pid sequence.
        """
        n = len(pids)
        if n == 0:
            return 0, 0
        arr = np.asarray(pids, np.int64)
        if (n == 1 or self.on_migrate is not None
                or len(self._stacks[Tier.FAST]) < n
                or bool(np.any(self._flags[arr] & np.uint8(_UNEVICTABLE)))):
            from repro_torch.core.page_pool import promote_pages_sequential

            return promote_pages_sequential(self, pids)
        assert bool(np.all(self._tier[arr] == np.int8(1))), \
            "promotion source must be SLOW"
        mask = np.asarray(self.control.admit_promotions(arr), bool)
        denied = int(n - np.count_nonzero(mask))
        if denied:
            self.vmstat.promote_fail(PromoteFail.QOS, denied)
        ok = arr[mask] if denied else arr
        k = len(ok)
        if k:
            # frames: k fast pops / k slow pushes, in candidate order
            slow_frames = self._frame[ok].copy()
            self._frame[ok] = self._stacks[Tier.FAST].pop_many(k)
            for pid in ok.tolist():  # unlink from the SLOW active lists
                self._lru_remove(self._lid[pid], pid)
            self._stacks[Tier.SLOW].push_many(slow_frames)
            self._flags[ok] = (
                self._flags[ok] & np.uint8(_NOT_DEMOTED)
            ) | np.uint8(_ACTIVE)
            self._tier[ok] = np.int8(int(Tier.FAST))
            ptypes = self._ptype[ok]
            anon_sel = ptypes == np.int8(int(PageType.ANON))
            n_anon = int(np.count_nonzero(anon_sel))
            if n_anon:
                self._lru_add_head_batch(1, ok[anon_sel])  # FAST/ANON/act
            if k - n_anon:
                self._lru_add_head_batch(3, ok[~anon_sel])  # FAST/FILE/act
            self.vmstat.promote_success(True, n_anon)
            self.vmstat.promote_success(False, k - n_anon)
            self.control.note_promote_many(ok)
        return k, denied

    def evict_page(self, pid: int) -> None:
        if self.on_evict is not None:
            self.on_evict(pid)
        self.free(pid)
        self.vmstat.pswpout += 1

    # ------------------------------------------------------------------ #
    # reclaim-candidate scan
    # ------------------------------------------------------------------ #
    def scan_reclaim_candidates(self, tier: Tier, nr_to_scan: int) -> List[int]:
        return self.control.order_demotion_victims(
            self._scan_reclaim_candidates(tier, nr_to_scan)
        )

    def _scan_reclaim_candidates(self, tier: Tier, nr_to_scan: int) -> List[int]:
        out: List[int] = []
        sizes = {
            pt: self._lens[_list_id(int(tier), int(pt), False)] for pt in PageType
        }
        total = sum(sizes.values())
        if total == 0:
            return out
        seen: set = set()
        lens = self._lens
        flags_arr = self._flags
        for pt in PageType:
            share = (
                max(1, round(nr_to_scan * sizes[pt] / total)) if sizes[pt] else 0
            )
            lid = _list_id(int(tier), int(pt), False)
            scanned = 0
            rotations = 0
            while (scanned < share and lens[lid] > 0
                   and rotations < lens[lid] + share):
                pid = self._tails[lid]
                if pid in seen:
                    break
                self.vmstat.pgscan += 1
                rotations += 1
                flags = flags_arr[pid].item()
                if flags & _UNEVICTABLE:
                    self._lru_rotate(lid, pid)
                    seen.add(pid)
                    continue
                if flags & _ACCESSED:
                    self.activate(pid)
                    continue
                out.append(pid)
                seen.add(pid)
                self._lru_rotate(lid, pid)
                scanned += 1
                if len(out) >= nr_to_scan:
                    return out
        return out

    # ------------------------------------------------------------------ #
    # accessor surface (repro_torch.core.policy.PlacementPool)
    # ------------------------------------------------------------------ #
    # The scalar accessors sit on the policies' per-candidate hot path;
    # `.item()` reads avoid numpy-scalar arithmetic and enum construction
    # costs that would otherwise dominate the promote loop.
    def has_page(self, pid: int) -> bool:
        return 0 <= pid < self._next_pid and self._live[pid].item()

    def live_mask(self, pids: np.ndarray) -> np.ndarray:
        return self._live[pids]

    def tier_of(self, pid: int) -> Tier:
        return Tier(self._tier[pid].item())

    def is_slow_live(self, pid: int) -> bool:
        """Live and slow-tier — the promotion loops' per-candidate gate."""
        return (0 <= pid < self._next_pid and self._live[pid].item()
                and self._tier[pid].item() == 1)

    def ptype_of(self, pid: int) -> PageType:
        return PageType(self._ptype[pid].item())

    def is_active(self, pid: int) -> bool:
        return bool(self._flags[pid].item() & _ACTIVE)

    def is_demoted(self, pid: int) -> bool:
        return bool(self._flags[pid].item() & _DEMOTED)

    def is_pinned(self, pid: int) -> bool:
        return bool(self._flags[pid].item() & _UNEVICTABLE)

    def touch_count_of(self, pid: int) -> int:
        return self._touch_count[pid].item()

    def demotion_victims(self, limit: int) -> List[int]:
        """Coldest unpinned fast pages by (touch_count, recency), vectorized.

        ``np.lexsort`` keys replicate the reference's stable sort over
        ascending-pid iteration order exactly: primary touch_count,
        secondary last-touch step, ties by pid.
        """
        n = self._next_pid
        mask = (
            self._live[:n]
            & (self._tier[:n] == np.int8(int(Tier.FAST)))
            & ((self._flags[:n] & _UNEVICTABLE) == 0)
        )
        pids = np.flatnonzero(mask)
        if len(pids) == 0:
            return []
        order = np.lexsort(
            (pids, self._last_touch[pids], self._touch_count[pids])
        )[:limit]
        return self.control.order_demotion_victims(
            [int(p) for p in pids[order]]
        )

    def fallback_slow_victim(self) -> Optional[int]:
        n = self._next_pid
        mask = (
            self._live[:n]
            & (self._tier[:n] == np.int8(int(Tier.SLOW)))
            & ((self._flags[:n] & _UNEVICTABLE) == 0)
        )
        idx = np.flatnonzero(mask)
        return int(idx[0]) if len(idx) else None

    # ------------------------------------------------------------------ #
    # introspection / invariants
    # ------------------------------------------------------------------ #
    def page(self, pid: int) -> PageView:
        return PageView(self, pid)

    def pages_in_tier(self, tier: Tier) -> List[int]:
        n = self._next_pid
        return [
            int(p)
            for p in np.flatnonzero(
                self._live[:n] & (self._tier[:n] == np.int8(int(tier)))
            )
        ]

    def occupancy(self) -> Dict[str, float]:
        return {
            "fast_used": self.used_frames(Tier.FAST),
            "fast_free": self.free_frames(Tier.FAST),
            "slow_used": self.used_frames(Tier.SLOW),
            "slow_free": self.free_frames(Tier.SLOW),
        }

    def _iter_list(self, lid: int) -> List[int]:
        out = []
        pid = self._heads[lid]
        while pid != -1:
            out.append(pid)
            pid = int(self._older[pid])
        return out

    def check_invariants(self) -> None:
        n = self._next_pid
        live = np.flatnonzero(self._live[:n])
        seen_frames = {Tier.FAST: set(), Tier.SLOW: set()}
        for pid in live:
            pid = int(pid)
            tier = Tier(int(self._tier[pid]))
            frame = int(self._frame[pid])
            assert frame not in seen_frames[tier], (
                f"frame {frame} double-mapped on {tier}"
            )
            seen_frames[tier].add(frame)
        for lid in range(8):
            members = self._iter_list(lid)
            assert len(members) == self._lens[lid], (
                f"list {lid} length {self._lens[lid]} != walked {len(members)}"
            )
            for pid in members:
                assert self._live[pid], f"dead page {pid} on list {lid}"
                assert self._lid_of(pid) == lid, (
                    f"page {pid} on list {lid} but state says {self._lid_of(pid)}"
                )
        assert sum(self._lens) == len(live), "LRU membership != live pages"
        for tier in (Tier.FAST, Tier.SLOW):
            free = set(
                int(f) for f in
                self._stacks[tier]._arr[: self._stacks[tier]._top]
            )
            assert len(free) == len(self._stacks[tier]), "free list duplicates"
            assert not (free & seen_frames[tier]), "frame both free and mapped"
            assert len(free) + len(seen_frames[tier]) == self.num_frames[tier]


def make_pool(
    engine: str,
    num_fast: int,
    num_slow: int,
    config: Optional[TppConfig] = None,
    on_migrate: Optional[Callable[[int, Tier, int, Tier, int], None]] = None,
    on_evict: Optional[Callable[[int], None]] = None,
):
    """Pool factory over the two engines (``reference`` | ``vectorized``)."""
    from repro_torch.core.page_pool import PagePool  # local import avoids cycle

    if engine == "reference":
        return PagePool(num_fast, num_slow, config=config,
                        on_migrate=on_migrate, on_evict=on_evict)
    if engine == "vectorized":
        return VectorPagePool(num_fast, num_slow, config=config,
                              on_migrate=on_migrate, on_evict=on_evict)
    raise ValueError(f"unknown engine {engine!r}; choose from {list(ENGINES)}")
