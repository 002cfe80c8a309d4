"""TierSan — leveled runtime invariant sanitizer for both pool engines.

Generalizes ``VectorPagePool.check_invariants`` into a checker that
attaches to *either* engine (:class:`~repro_torch.core.page_pool.PagePool`,
or the JAX package's ``repro.core.engine.VectorPagePool``, duck-typed)
behind a debug flag and runs
at every interval close (``pool.end_interval``), CONFIG_DEBUG_VM-style:

* ``conservation`` — cheap laws safe to leave on in long runs:
  per-tier frame accounting (``0 <= free <= capacity`` and
  ``live pages == used frames``), VmStat flow conservation
  (``pgalloc − pgfree == live``), counter monotonicity between checks,
  and tenant-ledger bounds (per-tenant sums vs pool/vmstat globals).
* ``full`` — everything above plus the engine's exact
  ``check_invariants()`` audit (frame double-maps, LRU walks, free-list
  duplicates) and the ledger's exact per-page residency audit
  (``TenantAccounting.check_consistency``).

Enable via environment::

    TIERSAN_LEVEL=conservation   # or: full
    TIERSAN_EVERY=8              # check every 8th interval (default 1)

Both pools call :func:`tiersan_from_env` at construction, so an env
flag is enough to sanitize an entire simulator/serving/benchmark run
without touching call sites.  Violations raise :class:`TierSanError`
with every broken law and a hint at the likely corruption source.

:func:`diff_engines` is the parity-triage companion: given a reference
and a vectorized pool mid-run, it reports exactly where their state
diverges (vmstat, frame accounting, page table rows, LRU orders)
instead of a bare trajectory mismatch at the end of a test.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np

#: Sanitizer levels, cheapest first.
LEVELS = ("off", "conservation", "full")


class TierSanError(AssertionError):
    """One or more tiering invariants are broken."""


def _is_vectorized(pool) -> bool:
    return hasattr(pool, "_live")


def _live_count(pool, tier) -> int:
    """Live pages resident on ``tier`` (vectorized: one masked count)."""
    if _is_vectorized(pool):
        n = pool._next_pid
        return int(np.count_nonzero(
            pool._live[:n] & (pool._tier[:n] == np.int8(int(tier)))
        ))
    return sum(1 for p in pool.pages.values() if p.tier == tier)


def _counters(pool) -> Dict[str, int]:
    return {k: int(v) for k, v in dataclasses.asdict(pool.vmstat).items()}


class TierSan:
    """Leveled invariant checker; attach one instance per pool."""

    def __init__(self, level: str = "conservation", every: int = 1) -> None:
        if level not in LEVELS:
            raise ValueError(
                f"unknown TierSan level {level!r}; choose from {list(LEVELS)}"
            )
        self.level = level
        self.every = max(1, int(every))
        self.intervals = 0
        self.checks = 0
        self._last_counters: Optional[Dict[str, int]] = None

    # ---------------------------------------------------------------- #
    # entry points
    # ---------------------------------------------------------------- #
    def on_interval(self, pool) -> None:
        """Interval-close hook (called from ``pool.end_interval``)."""
        if self.level == "off":
            return
        self.intervals += 1
        if self.intervals % self.every:
            return
        self.check(pool, full=(self.level == "full"))

    def check(self, pool, full: bool = False) -> None:
        """Run the conservation laws (and the full audit if asked);
        raises :class:`TierSanError` listing every violated law."""
        self.checks += 1
        errs: List[str] = []
        live = {}
        for tier in pool.num_frames:
            live[tier] = _live_count(pool, tier)
        errs += self._check_frames(pool, live)
        errs += self._check_vmstat(pool, sum(live.values()))
        errs += self._check_ledger(pool, live)
        if full:
            errs += self._check_full(pool)
        if errs:
            detail = "\n  - ".join(errs)
            raise TierSanError(
                f"TierSan[{self.level}] check #{self.checks} on "
                f"{type(pool).__name__} (step {pool.step}): "
                f"{len(errs)} violation(s)\n  - {detail}"
            )

    # ---------------------------------------------------------------- #
    # conservation laws
    # ---------------------------------------------------------------- #
    def _check_frames(self, pool, live: Dict) -> List[str]:
        errs = []
        for tier, cap in pool.num_frames.items():
            free = pool.free_frames(tier)
            if not 0 <= free <= cap:
                errs.append(
                    f"[frame-accounting] {tier.name}: free={free} outside "
                    f"[0, {cap}]; hint: free-stack underflow/overflow "
                    "(unbalanced pop/push in a batch path)"
                )
                continue
            used = cap - free
            if live[tier] != used:
                errs.append(
                    f"[frame-accounting] {tier.name}: {live[tier]} live "
                    f"pages but {used} used frames (capacity {cap}, free "
                    f"{free}); hint: a page freed/migrated without "
                    "returning its frame, or a frame leaked by a batch op"
                )
        return errs

    def _check_vmstat(self, pool, live_total: int) -> List[str]:
        errs = []
        c = _counters(pool)
        alloc = c["pgalloc_fast"] + c["pgalloc_slow"]
        if alloc - c["pgfree"] != live_total:
            errs.append(
                f"[vmstat-flow] pgalloc({alloc}) - pgfree({c['pgfree']}) = "
                f"{alloc - c['pgfree']} != {live_total} live pages; hint: "
                "an alloc/free path skipped its counter, or pages were "
                "created/destroyed outside allocate()/free()"
            )
        if c["pswpout"] > c["pgfree"]:
            errs.append(
                f"[vmstat-flow] pswpout({c['pswpout']}) > "
                f"pgfree({c['pgfree']}); hint: evict_page counted without "
                "its free()"
            )
        if self._last_counters is not None:
            for name, value in c.items():
                prev = self._last_counters.get(name, 0)
                if value < prev:
                    errs.append(
                        f"[vmstat-monotone] {name} decreased "
                        f"{prev} -> {value} between checks; hint: a "
                        "counter was reset or overwritten mid-run"
                    )
        self._last_counters = c
        return errs

    def _check_ledger(self, pool, live: Dict) -> List[str]:
        ctl = pool.control
        if not (hasattr(ctl, "fast_pages") and hasattr(ctl, "slow_pages")):
            return []  # no tenant ledger attached
        errs = []
        for name in ("fast_pages", "slow_pages",
                     "promoted_total", "demoted_total"):
            arr = getattr(ctl, name, None)
            if arr is not None and len(arr) and int(np.min(arr)) < 0:
                t = int(np.argmin(arr))
                errs.append(
                    f"[ledger-bounds] {name}[{t}] = {int(arr[t])} < 0; "
                    "hint: double-counted free/demote for that tenant"
                )
        used_by_int = {int(tier): live[tier] for tier in pool.num_frames}
        sums = {
            "fast_pages": int(np.sum(ctl.fast_pages)),
            "slow_pages": int(np.sum(ctl.slow_pages)),
        }
        for name, tier_used in (("fast_pages", used_by_int.get(0, 0)),
                                ("slow_pages", used_by_int.get(1, 0))):
            if sums[name] > tier_used:
                errs.append(
                    f"[ledger-bounds] sum({name})={sums[name]} > "
                    f"{tier_used} resident pages; hint: ledger drift — a "
                    "page changed tier/tenant without a note_* event"
                )
        vm = pool.vmstat
        if hasattr(ctl, "promoted_total") and \
                int(np.sum(ctl.promoted_total)) > vm.pgpromote_total:
            errs.append(
                f"[ledger-bounds] sum(promoted_total)="
                f"{int(np.sum(ctl.promoted_total))} > vmstat "
                f"pgpromote_total={vm.pgpromote_total}; hint: note_promote "
                "fired without a successful migration"
            )
        if hasattr(ctl, "demoted_total") and \
                int(np.sum(ctl.demoted_total)) > vm.pgdemote_total:
            errs.append(
                f"[ledger-bounds] sum(demoted_total)="
                f"{int(np.sum(ctl.demoted_total))} > vmstat "
                f"pgdemote_total={vm.pgdemote_total}; hint: note_demote "
                "fired without a successful migration"
            )
        return errs

    # ---------------------------------------------------------------- #
    # full audit
    # ---------------------------------------------------------------- #
    def _check_full(self, pool) -> List[str]:
        errs = []
        try:
            pool.check_invariants()
        except AssertionError as e:
            errs.append(
                f"[full-audit] check_invariants: {e}; hint: see the "
                "failing assertion for the corrupted structure"
            )
        ctl = pool.control
        if hasattr(ctl, "check_consistency"):
            try:
                ctl.check_consistency(pool)
            except AssertionError as e:
                errs.append(
                    f"[full-audit] ledger check_consistency: {e}; hint: "
                    "per-tenant residency diverged from the page table"
                )
        return errs


def check_fleet_conservation(coordinator) -> None:
    """TierSan's fleet law: one global budget, conserved across shards.

    Given a fleet coordinator (duck-typed: the JAX package's
    ``repro.fleet.coordinator.FleetCoordinator``), verify
    the cross-shard budget invariants the push-down path must preserve:

    * ``sum(shard budgets) == global_budget`` exactly — the coordinator
      may move frames between shards but never mint or leak them;
    * every shard budget respects its clamps
      (``min_budget <= budget <= physical_fast``);
    * each shard's *pool* agrees (``pool.fast_budget`` matches, and the
      watermarks are exactly ``frames_for_budget(physical, budget)``) —
      a budget that never reached the watermarks is a silent no-op;
    * each quota-keeping *control* agrees (``fast_frames == budget``) —
      quotas divided over a stale capacity drift from the watermarks.

    Raises :class:`TierSanError` listing every violated law.
    """
    errs: List[str] = []
    budgets = [int(p.budget) for p in coordinator.pools]
    if sum(budgets) != coordinator.global_budget:
        errs.append(
            f"[fleet-conservation] shard budgets sum to {sum(budgets)} != "
            f"global budget {coordinator.global_budget}; hint: a push "
            "skipped a shard, or a shard's budget was mutated outside "
            "the coordinator"
        )
    lo = coordinator.config.min_budget
    for p, b in zip(coordinator.pools, budgets):
        if not lo <= b <= p.physical_fast:
            errs.append(
                f"[fleet-clamps] {p.key}: budget {b} outside "
                f"[{lo}, {p.physical_fast}]; hint: division clamps bypassed"
            )
            continue
        pool_budget = getattr(p.pool, "fast_budget", None)
        if pool_budget != b:
            errs.append(
                f"[fleet-pushdown] {p.key}: shard budget {b} but "
                f"pool.fast_budget={pool_budget}; hint: apply_budget "
                "bypassed pool.set_fast_budget"
            )
        expected = p.pool.config.frames_for_budget(p.physical_fast, b)
        actual = (p.pool.wm_min, p.pool.wm_alloc, p.pool.wm_demote)
        if actual != expected:
            errs.append(
                f"[fleet-pushdown] {p.key}: watermarks {actual} != "
                f"frames_for_budget({p.physical_fast}, {b})={expected}; "
                "hint: watermarks were overwritten after the push-down"
            )
        ctl_frames = getattr(p.control, "fast_frames", None)
        if ctl_frames is not None and int(ctl_frames) != b:
            errs.append(
                f"[fleet-pushdown] {p.key}: control.fast_frames="
                f"{int(ctl_frames)} but budget {b}; hint: the control "
                "missed its set_fast_budget forward"
            )
    if errs:
        detail = "\n  - ".join(errs)
        raise TierSanError(
            f"TierSan[fleet] on {len(coordinator.pools)} shards: "
            f"{len(errs)} violation(s)\n  - {detail}"
        )


def tiersan_from_env(env=None) -> Optional[TierSan]:
    """Build a :class:`TierSan` from ``TIERSAN_LEVEL``/``TIERSAN_EVERY``
    (``None`` when disabled) — called by both pool constructors."""
    env = os.environ if env is None else env
    level = (env.get("TIERSAN_LEVEL") or "off").strip().lower()
    if level in ("", "off", "0"):
        return None
    every = int(env.get("TIERSAN_EVERY") or 1)
    return TierSan(level, every=every)


# --------------------------------------------------------------------- #
# differential engine parity
# --------------------------------------------------------------------- #
def _lru_orders(pool) -> Dict[str, List[int]]:
    """Oldest→newest pid order of every (tier, type, active) LRU list."""
    out: Dict[str, List[int]] = {}
    if _is_vectorized(pool):
        for lid in range(8):
            tier = "FAST" if lid < 4 else "SLOW"
            ptype = "ANON" if (lid % 4) < 2 else "FILE"
            act = "active" if lid % 2 else "inactive"
            out[f"{tier}/{ptype}/{act}"] = list(
                reversed(pool._iter_list(lid))
            )
        return out
    for tier, node in pool.lru.items():
        for pt_i, pt_name in ((0, "ANON"), (1, "FILE")):
            for act_i, act in ((0, "inactive"), (1, "active")):
                lst = node.lists[pt_i][act_i]
                out[f"{tier.name}/{pt_name}/{act}"] = list(lst.iter_oldest())
    return out


def _page_rows(pool) -> Dict[int, tuple]:
    """pid -> (tier, ptype, frame, flags, touch_count, last_touch, history)."""
    if _is_vectorized(pool):
        n = pool._next_pid
        out = {}
        for pid in np.flatnonzero(pool._live[:n]).tolist():
            out[pid] = (
                int(pool._tier[pid]), int(pool._ptype[pid]),
                int(pool._frame[pid]), int(pool._flags[pid]),
                int(pool._touch_count[pid]), int(pool._last_touch[pid]),
                int(pool._history[pid]),
            )
        return out
    return {
        p.pid: (int(p.tier), int(p.page_type), p.frame, int(p.flags),
                p.touch_count, p.last_touch_step, p.history)
        for p in pool.pages.values()
    }


_ROW_FIELDS = ("tier", "ptype", "frame", "flags", "touch_count",
               "last_touch", "history")


def diff_engines(reference, vectorized, max_items: int = 20) -> Dict[str, List[str]]:
    """Diff a reference and a vectorized pool mid-run for parity triage.

    Returns ``{category: [mismatch descriptions]}`` — empty dict means
    the engines agree.  Categories: ``vmstat``, ``frames``, ``pages``,
    ``lru``.  ``max_items`` truncates each category's listing.
    """
    if _is_vectorized(reference) and not _is_vectorized(vectorized):
        reference, vectorized = vectorized, reference
    out: Dict[str, List[str]] = {}

    ref_c, vec_c = _counters(reference), _counters(vectorized)
    vm = [
        f"{k}: reference={ref_c[k]} vectorized={vec_c[k]}"
        for k in sorted(ref_c)
        if ref_c[k] != vec_c.get(k)
    ]
    if vm:
        out["vmstat"] = vm[:max_items]

    frames = []
    for tier in reference.num_frames:
        rf, vf = reference.free_frames(tier), vectorized.free_frames(tier)
        if rf != vf:
            frames.append(f"{tier.name} free: reference={rf} vectorized={vf}")
    if reference.step != vectorized.step:
        frames.append(
            f"step: reference={reference.step} vectorized={vectorized.step}"
        )
    if frames:
        out["frames"] = frames[:max_items]

    ref_rows, vec_rows = _page_rows(reference), _page_rows(vectorized)
    pages = []
    only_ref = sorted(set(ref_rows) - set(vec_rows))
    only_vec = sorted(set(vec_rows) - set(ref_rows))
    if only_ref:
        pages.append(f"pids live only in reference: {only_ref[:max_items]}")
    if only_vec:
        pages.append(f"pids live only in vectorized: {only_vec[:max_items]}")
    for pid in sorted(set(ref_rows) & set(vec_rows)):
        if ref_rows[pid] != vec_rows[pid]:
            diffs = ", ".join(
                f"{f}: {r}!={v}"
                for f, r, v in zip(_ROW_FIELDS, ref_rows[pid], vec_rows[pid])
                if r != v
            )
            pages.append(f"pid {pid}: {diffs}")
            if len(pages) >= max_items:
                break
    if pages:
        out["pages"] = pages[:max_items]

    lru = []
    ref_lru, vec_lru = _lru_orders(reference), _lru_orders(vectorized)
    for key in sorted(ref_lru):
        if ref_lru[key] != vec_lru.get(key):
            lru.append(
                f"{key}: reference={ref_lru[key][:max_items]} "
                f"vectorized={vec_lru.get(key, [])[:max_items]}"
            )
    if lru:
        out["lru"] = lru[:max_items]
    return out
