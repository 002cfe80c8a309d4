"""Tier-faithful placement simulator.

Runs a synthetic workload trace (``repro_torch.core.trace``) against a page
pool driven by any placement policy (TPP or a baseline) and charges
modeled access costs per tier — the CPU-only stand-in for the paper's
production runs (§6).  The *mechanism* is exact (real pool, real LRU,
real migrations); only the clock is modeled:

* fast-tier access  = 1.0 (local DRAM ~100 ns)
* slow-tier access  = ``slow_cost`` (paper Fig. 2: CXL ≈ 1.5-3×)
* migration         = ``migrate_cost`` per page (background, amortized)
* refault (evicted) = ``refault_cost`` (major fault + swap-in analogue)

Two execution engines share the same semantics (``engine=``):

* ``reference``  — the dict-of-``Page`` :class:`PagePool` with a
  per-event Python loop (the executable specification);
* ``vectorized`` — the struct-of-arrays
  :class:`~repro_torch.core.engine.VectorPagePool` with batched allocation,
  touch and interval handling (the production-scale engine; ≥10× the
  reference throughput on fleet-scale traces, bit-identical results).

Multi-tenant traces (``"web+cache1"``) run through either engine; the
simulator attributes per-tenant vmstat-style counters (fast/slow
accesses, allocations, refaults) via the trace's tenant encoding.

Throughput is reported normalized to the ideal all-fast baseline exactly
like the paper's Table 1 (accesses per unit modeled time, ideal = 1.0).

A copy of ``repro.core.simulator`` with the same behaviour; the port keeps its own
so that it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.chameleon import Chameleon
from repro_torch.core.engine import ENGINES, make_pool
from repro_torch.core.policy import make_policy
from repro_torch.core.trace import make_trace, workload_total_pages
from repro_torch.core.types import PageType, Tier, TppConfig
from repro_torch.core.vmstat import VmStat


@dataclasses.dataclass
class SimResult:
    policy: str
    workload: str
    steps: int
    total_accesses: int
    modeled_time: float
    ideal_time: float
    vmstat: VmStat
    # per-step timeline for the Fig. 14/15/17/18-style plots
    local_fraction: List[float]
    promote_rate: List[int]
    demote_rate: List[int]
    alloc_fast_rate: List[int]
    # Fraction of application runtime that is memory-stall time in the
    # ideal configuration.  The paper's applications lose ≤18% end-to-end
    # even with most traffic remote at 2-3× latency (Table 1), i.e. they
    # are far from 100% memory-bound; β captures that (MLP/compute overlap).
    mem_stall_frac: float = 0.25
    # Per-tenant vmstat attribution (multi-tenant traces only):
    # tenant id -> {"access_fast", "access_slow", "allocated", "refaults",
    # "promoted", "demoted"}.
    per_tenant: Optional[Dict[int, Dict[str, int]]] = None
    tenant_names: Optional[List[str]] = None
    # Modeled cost knobs (echoed from the simulator so the fairness
    # metrics below are self-contained).
    slow_cost: float = 2.0
    refault_cost: float = 50.0
    # QoS arbitration summary (quotas, violations, denials) when a
    # QosArbiter drove this run; None otherwise.
    qos: Optional[Dict] = None

    @property
    def decision_timeline(self) -> Optional[List[Dict]]:
        """Per-interval control-plane decision deltas (steered / denied /
        shed / share vector) recorded by the arbiter; ``None`` without a
        QoS control plane."""
        if self.qos is None:
            return None
        return self.qos.get("timeline")

    @property
    def avg_access_cost(self) -> float:
        """Mean modeled memory-access cost (ideal = 1.0)."""
        return self.modeled_time / self.ideal_time if self.ideal_time else 1.0

    @property
    def raw_throughput_vs_ideal(self) -> float:
        """Pure memory-time ratio (100%-memory-bound upper bound on loss)."""
        return self.ideal_time / self.modeled_time if self.modeled_time else 1.0

    @property
    def throughput_vs_ideal(self) -> float:
        """Application-level throughput normalized to ideal (Table 1).

        runtime = (1-β)·compute + β·memtime, normalized so ideal = 1.
        """
        b = self.mem_stall_frac
        return 1.0 / ((1.0 - b) + b * self.avg_access_cost)

    @property
    def mean_local_fraction(self) -> float:
        return float(np.mean(self.local_fraction)) if self.local_fraction else 1.0

    def summary(self) -> Dict[str, float]:
        return {
            "policy": self.policy,
            "workload": self.workload,
            "throughput_vs_ideal": round(self.throughput_vs_ideal, 4),
            "raw_throughput": round(self.raw_throughput_vs_ideal, 4),
            "local_fraction": round(self.mean_local_fraction, 4),
            "demoted": self.vmstat.pgdemote_total,
            "promoted": self.vmstat.pgpromote_total,
            "ping_pong_rate": round(self.vmstat.ping_pong_rate, 4),
            "evicted": self.vmstat.pswpout,
            "alloc_stalls": self.vmstat.pgalloc_stall,
        }

    def tenant_summary(self) -> Optional[Dict[str, Dict[str, float]]]:
        """Per-tenant local fractions keyed by tenant display name."""
        if self.per_tenant is None:
            return None
        out: Dict[str, Dict[str, float]] = {}
        for tid, acc in sorted(self.per_tenant.items()):
            name = (
                f"{tid}:{self.tenant_names[tid]}"
                if self.tenant_names and tid < len(self.tenant_names)
                else str(tid)
            )
            total = acc["access_fast"] + acc["access_slow"]
            out[name] = {
                **acc,
                "local_fraction": round(acc["access_fast"] / total, 4)
                if total else 1.0,
            }
        return out

    # -- fairness metrics (Equilibria-style multi-tenant evaluation) ---- #
    def tenant_slowdowns(self) -> Optional[Dict[int, float]]:
        """Per-tenant modeled memory slowdown (ideal all-fast = 1.0).

        ``(fast + slow·slow_cost + refaults·refault_cost) / accesses`` —
        the per-tenant analogue of :attr:`avg_access_cost`.
        """
        if self.per_tenant is None:
            return None
        out: Dict[int, float] = {}
        for tid, acc in sorted(self.per_tenant.items()):
            n = acc["access_fast"] + acc["access_slow"]
            t = (acc["access_fast"] + acc["access_slow"] * self.slow_cost
                 + acc.get("refaults", 0) * self.refault_cost)
            out[tid] = round(t / n, 4) if n else 1.0
        return out

    def jains_fairness(self) -> Optional[float]:
        """Jain's index over per-tenant normalized throughput (1/slowdown).

        1.0 = perfectly even slowdowns; 1/n = one tenant absorbs all of
        the tiering penalty.
        """
        slow = self.tenant_slowdowns()
        if not slow:
            return None
        x = np.asarray([1.0 / v for v in slow.values()], np.float64)
        return round(float((x.sum() ** 2) / (len(x) * (x * x).sum())), 4)

    def fairness_summary(self) -> Optional[Dict]:
        slow = self.tenant_slowdowns()
        if slow is None:
            return None
        names = self.tenant_names or []
        return {
            "slowdowns": {
                (f"{t}:{names[t]}" if t < len(names) else str(t)): v
                for t, v in slow.items()
            },
            "jains_index": self.jains_fairness(),
            "quota_violation_intervals": (
                self.qos.get("quota_violation_intervals") if self.qos else None
            ),
        }


class TieredSimulator:
    """Drive (trace × pool × policy) and account modeled time."""

    def __init__(
        self,
        workload: str,
        policy: str,
        fast_frames: int,
        slow_frames: int,
        config: Optional[TppConfig] = None,
        slow_cost: float = 2.0,
        migrate_cost: float = 0.05,
        refault_cost: float = 50.0,
        interval_steps: int = 4,
        seed: int = 0,
        profiler: Optional[Chameleon] = None,
        trace=None,
        engine: str = "reference",
        qos=None,
    ) -> None:
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
        self.workload = workload
        self.policy_name = policy
        self.engine = engine
        self.slow_cost = slow_cost
        self.migrate_cost = migrate_cost
        self.refault_cost = refault_cost
        self.interval_steps = interval_steps
        self.pool = make_pool(engine, fast_frames, slow_frames, config=config)
        self.policy = make_policy(policy, self.pool, seed=seed)
        self.trace = trace if trace is not None else make_trace(workload, seed=seed)
        self.profiler = profiler
        # tenant attribution (multi-tenant traces expose tenant_of)
        self._tenant_of = getattr(self.trace, "tenant_of", None)
        self._tenant_of_array = getattr(self.trace, "tenant_of_array", None)
        self._per_tenant: Dict[int, Dict[str, int]] = {}
        # reference engine: trace-local index -> pid (None if evicted)
        self._pid_of: Dict[int, Optional[int]] = {}
        self._ptype_of: Dict[int, PageType] = {}
        # vectorized engine: the same maps as flat arrays (−1 = absent)
        self._v_pid_of = np.full(1024, -1, np.int64)
        self._v_ptype_of = np.full(1024, -1, np.int16)
        self._evicted_pids: set = set()
        self._last_evicted: Optional[int] = None
        self.pool.on_evict = self._note_evict
        # -- tiering control plane (core.control / repro_torch.qos) ------ #
        # ``qos`` is a QosConfig (→ QosArbiter), a
        # SlowdownControllerConfig (→ SlowdownController) or a ready
        # TieringControl; with a plain multi-tenant trace a
        # telemetry-only TenantAccounting is attached so per-tenant
        # promote/demote attribution is always available.  Imports are
        # lazy to keep repro_torch.core importable from repro_torch.qos
        # without a cycle.
        n_tenants = getattr(self.trace, "n_tenants", 1)
        self.control = None
        if qos is not None:
            from repro_torch.qos import make_control

            self.control = make_control(qos, n_tenants, fast_frames)
        elif self._tenant_of is not None:
            from repro_torch.qos.accounting import TenantAccounting

            self.control = TenantAccounting(n_tenants)
        if self.control is not None:
            self.pool.control = self.control
        self._fast_counts = np.zeros(n_tenants, np.int64)
        self._slow_counts = np.zeros(n_tenants, np.int64)

    def _note_evict(self, pid: int) -> None:
        self._evicted_pids.add(pid)
        self._last_evicted = pid

    def _tenant_acc(self, tid: int) -> Dict[str, int]:
        acc = self._per_tenant.get(tid)
        if acc is None:
            acc = {"access_fast": 0, "access_slow": 0,
                   "allocated": 0, "refaults": 0}
            self._per_tenant[tid] = acc
        return acc

    def tenant_counters(self) -> Dict[int, Dict[str, int]]:
        """Copy of the cumulative per-tenant vmstat attribution.

        Counters accumulate across chunked ``run()`` calls, so a caller
        (e.g. the fleet simulator) can snapshot here and diff later to
        measure an arbitrary window.
        """
        return {t: dict(acc) for t, acc in self._per_tenant.items()}

    # ---------------------------------------------------------------- #
    def run(self, steps: int, measure_from: int = 0) -> SimResult:
        """Run ``steps``; throughput accounting starts at ``measure_from``.

        The paper reports steady-state throughput after workloads converge
        (§6.1: convergence takes minutes); ``measure_from`` excludes the
        warm-up transient the same way.
        """
        if self.engine == "vectorized":
            return self._run_vectorized(steps, measure_from)
        return self._run_reference(steps, measure_from)

    # ---------------------------------------------------------------- #
    # reference engine: per-event loop over the dict-of-Page pool
    # ---------------------------------------------------------------- #
    def _run_reference(self, steps: int, measure_from: int) -> SimResult:
        modeled_time = 0.0
        ideal_time = 0.0
        total_accesses = 0
        local_frac: List[float] = []
        promote_rate: List[int] = []
        demote_rate: List[int] = []
        alloc_fast_rate: List[int] = []
        tenant_of = self._tenant_of
        ctl = self.control
        fast_counts = self._fast_counts
        slow_counts = self._slow_counts

        for step_no in range(steps):
            ev = next(self.trace)
            alloc_fast_before = self.pool.vmstat.pgalloc_fast

            # -- allocations ---------------------------------------- #
            for idx, ptype in ev.allocs:
                self._alloc_idx(idx, ptype)

            # -- frees ----------------------------------------------- #
            for idx in ev.frees:
                pid = self._pid_of.pop(idx, None)
                self._ptype_of.pop(idx, None)
                if pid is not None and pid in self.pool.pages:
                    if self.profiler is not None:
                        self.profiler.note_free(pid)
                    self.pool.free(pid)

            # -- accesses -------------------------------------------- #
            step_time = 0.0
            step_ideal = 0.0
            slow_hits: List[int] = []
            fast_hits: List[int] = []
            prof_events = []
            for idx in ev.accesses:
                if idx not in self._ptype_of:
                    continue  # freed before access
                pid = self._pid_of.get(idx)
                if pid is None or pid not in self.pool.pages:
                    # refault: page was evicted → recreate (major fault)
                    step_time += self.refault_cost
                    if tenant_of is not None:
                        self._tenant_acc(tenant_of(idx))["refaults"] += 1
                    self._alloc_idx(idx, self._ptype_of[idx])
                    pid = self._pid_of[idx]
                tier = self.pool.touch(pid)
                if tier == Tier.SLOW:
                    step_time += self.slow_cost
                    slow_hits.append(pid)
                else:
                    step_time += 1.0
                    fast_hits.append(pid)
                if tenant_of is not None:
                    tid = tenant_of(idx)
                    acc = self._tenant_acc(tid)
                    acc["access_slow" if tier == Tier.SLOW else "access_fast"] += 1
                    if ctl is not None:
                        (slow_counts if tier == Tier.SLOW
                         else fast_counts)[tid] += 1
                elif ctl is not None:
                    (slow_counts if tier == Tier.SLOW
                     else fast_counts)[0] += 1
                step_ideal += 1.0
                if self.profiler is not None:
                    prof_events.append((pid, self.pool.pages[pid].page_type))
            if self.profiler is not None:
                self.profiler.record(prof_events)

            # -- policy (uniform protocol dispatch) ------------------- #
            if ctl is not None:
                ctl.note_access_tiers(fast_counts, slow_counts)
                fast_counts[:] = 0
                slow_counts[:] = 0
            report = self.policy.step(slow_hits, fast_hits)
            step_time += (report.demoted + report.promoted) * self.migrate_cost
            if step_no >= measure_from:
                modeled_time += step_time
                ideal_time += step_ideal
                total_accesses += len(slow_hits) + len(fast_hits)

            # -- bookkeeping ------------------------------------------ #
            vs = self.pool.vmstat
            step_total = len(slow_hits) + len(fast_hits)
            local_frac.append(len(fast_hits) / step_total if step_total else 1.0)
            promote_rate.append(report.promoted)
            demote_rate.append(report.demoted)
            alloc_fast_rate.append(vs.pgalloc_fast - alloc_fast_before)

            if (step_no + 1) % self.interval_steps == 0:
                self.pool.end_interval()  # also ticks control.note_interval
                if self.profiler is not None:
                    self.profiler.end_interval()

        return self._result(steps, total_accesses, modeled_time, ideal_time,
                            local_frac, promote_rate, demote_rate,
                            alloc_fast_rate)

    # ---------------------------------------------------------------- #
    # vectorized engine: batched step processing over the SoA pool
    # ---------------------------------------------------------------- #
    def _ensure_idx_capacity(self, max_idx: int) -> None:
        if max_idx < len(self._v_pid_of):
            return
        new_cap = max(max_idx + 1, 2 * len(self._v_pid_of))
        pid_of = np.full(new_cap, -1, np.int64)
        pid_of[: len(self._v_pid_of)] = self._v_pid_of
        ptype_of = np.full(new_cap, -1, np.int16)
        ptype_of[: len(self._v_ptype_of)] = self._v_ptype_of
        self._v_pid_of = pid_of
        self._v_ptype_of = ptype_of

    def _alloc_idx_vec(self, idx: int, ptype: PageType) -> int:
        """Scalar allocation with the eviction-retry OOM handler."""
        tid = self._tenant_of(idx) if self._tenant_of is not None else 0
        try:
            page = self.pool.allocate(ptype, tenant=tid)
        except MemoryError:
            victim = self._coldest_slow_page()
            if victim is None:
                raise
            self.pool.evict_page(victim)
            page = self.pool.allocate(ptype, tenant=tid)
        self._ensure_idx_capacity(idx)
        self._v_pid_of[idx] = page.pid
        self._v_ptype_of[idx] = int(ptype)
        if self._tenant_of is not None:
            self._tenant_acc(tid)["allocated"] += 1
        return page.pid

    def _run_vectorized(self, steps: int, measure_from: int) -> SimResult:
        pool = self.pool
        modeled_time = 0.0
        ideal_time = 0.0
        total_accesses = 0
        local_frac: List[float] = []
        promote_rate: List[int] = []
        demote_rate: List[int] = []
        alloc_fast_rate: List[int] = []
        slow_tier = np.int8(int(Tier.SLOW))
        tenant_arr = self._tenant_of_array
        n_tenants = getattr(self.trace, "n_tenants", 1)
        ctl = self.control
        fast_counts = self._fast_counts
        slow_counts = self._slow_counts

        for step_no in range(steps):
            ev = next(self.trace)
            alloc_fast_before = pool.vmstat.pgalloc_fast

            # -- allocations: batch runs of equal page type ----------- #
            allocs = ev.allocs
            i = 0
            n_allocs = len(allocs)
            while i < n_allocs:
                pt = allocs[i][1]
                j = i + 1
                while j < n_allocs and allocs[j][1] == pt:
                    j += 1
                run_idx = np.fromiter(
                    (a[0] for a in allocs[i:j]), np.int64, count=j - i
                )
                run_tids = tenant_arr(run_idx) if tenant_arr is not None else 0
                placed = pool.try_allocate_many(pt, j - i, tenants=run_tids)
                if placed is None:
                    # near-OOM or a steering control: the per-page path
                    # owns eviction-retry + per-allocation steering
                    for a in allocs[i:j]:
                        self._alloc_idx_vec(a[0], pt)
                else:
                    pids, tiers = placed
                    self._ensure_idx_capacity(int(run_idx.max()))
                    self._v_pid_of[run_idx] = pids
                    self._v_ptype_of[run_idx] = np.int16(int(pt))
                    if tenant_arr is not None:
                        tids = np.bincount(run_tids, minlength=n_tenants)
                        for tid in np.flatnonzero(tids):
                            self._tenant_acc(int(tid))["allocated"] += int(tids[tid])
                i = j

            # -- frees ----------------------------------------------- #
            for idx in ev.frees:
                if idx >= len(self._v_pid_of):
                    continue  # never allocated (reference: dict.pop no-op)
                pid = int(self._v_pid_of[idx])
                self._v_pid_of[idx] = -1
                self._v_ptype_of[idx] = -1
                if pid >= 0 and pool.has_page(pid):
                    if self.profiler is not None:
                        self.profiler.note_free(pid)
                    pool.free(pid)

            # -- accesses: batched touch with scalar refault repair --- #
            step_time = 0.0
            step_ideal = 0.0
            slow_parts: List[np.ndarray] = []
            fast_parts: List[np.ndarray] = []
            prof_events = []
            idxs = np.fromiter(ev.accesses, np.int64, count=len(ev.accesses))
            if len(idxs):
                # unknown or freed-before-access indices are skipped, same
                # as the reference `idx not in self._ptype_of` guard
                idxs = idxs[idxs < len(self._v_ptype_of)]
            if len(idxs):
                idxs = idxs[self._v_ptype_of[idxs] >= 0]
            # Liveness is gathered ONCE per step; a refault only changes
            # the refaulted index (new pid) and — when its allocation had
            # to evict a victim — that one victim pid.  Both are patched
            # into the prefetched arrays with cheap vector compares, so
            # per-step cost stays linear in accesses even when the trace
            # is refault-heavy (the reference loop's behaviour, batched).
            pids = self._v_pid_of[idxs] if len(idxs) else idxs
            alive = (
                (pids >= 0) & pool.live_mask(np.maximum(pids, 0))
                if len(idxs) else np.empty(0, bool)
            )
            pos = 0
            n_idx = len(idxs)
            while pos < n_idx:
                rest = alive[pos:]
                n_chunk = len(rest) if rest.all() else int(np.argmin(rest))
                if n_chunk:
                    chunk_idx = idxs[pos : pos + n_chunk]
                    chunk_pids = pids[pos : pos + n_chunk]
                    tiers = pool.touch_many(chunk_pids)
                    slow_sel = tiers == slow_tier
                    n_slow = int(np.count_nonzero(slow_sel))
                    slow_parts.append(chunk_pids[slow_sel])
                    fast_parts.append(chunk_pids[~slow_sel])
                    step_time += n_slow * self.slow_cost + (n_chunk - n_slow)
                    step_ideal += n_chunk
                    if tenant_arr is not None:
                        tids = tenant_arr(chunk_idx)
                        slow_cnt = np.bincount(tids[slow_sel], minlength=n_tenants)
                        fast_cnt = np.bincount(tids[~slow_sel], minlength=n_tenants)
                        for tid in np.flatnonzero(slow_cnt + fast_cnt):
                            acc = self._tenant_acc(int(tid))
                            acc["access_slow"] += int(slow_cnt[tid])
                            acc["access_fast"] += int(fast_cnt[tid])
                        if ctl is not None:
                            fast_counts += fast_cnt
                            slow_counts += slow_cnt
                    elif ctl is not None:
                        fast_counts[0] += n_chunk - n_slow
                        slow_counts[0] += n_slow
                    if self.profiler is not None:
                        for p in chunk_pids.tolist():
                            prof_events.append((p, pool.ptype_of(p)))
                    pos += n_chunk
                if pos < n_idx and not alive[pos]:
                    # refault: page was evicted → recreate (major fault)
                    idx = int(idxs[pos])
                    step_time += self.refault_cost
                    if self._tenant_of is not None:
                        self._tenant_acc(self._tenant_of(idx))["refaults"] += 1
                    self._last_evicted = None
                    pid = self._alloc_idx_vec(idx, PageType(int(self._v_ptype_of[idx])))
                    if pos + 1 < n_idx:
                        # patch the prefetched suffix: this index now maps
                        # to the new live pid ...
                        same_idx = idxs[pos + 1 :] == idx
                        pids[pos + 1 :][same_idx] = pid
                        alive[pos + 1 :][same_idx] = True
                        # ... and the eviction victim (if any) went dead
                        if self._last_evicted is not None:
                            alive[pos + 1 :][
                                pids[pos + 1 :] == self._last_evicted
                            ] = False
                    tier = pool.touch(pid)
                    if tier == Tier.SLOW:
                        step_time += self.slow_cost
                        slow_parts.append(np.asarray([pid], np.int64))
                    else:
                        step_time += 1.0
                        fast_parts.append(np.asarray([pid], np.int64))
                    if self._tenant_of is not None:
                        tid = self._tenant_of(idx)
                        acc = self._tenant_acc(tid)
                        acc["access_slow" if tier == Tier.SLOW
                            else "access_fast"] += 1
                        if ctl is not None:
                            (slow_counts if tier == Tier.SLOW
                             else fast_counts)[tid] += 1
                    elif ctl is not None:
                        (slow_counts if tier == Tier.SLOW
                         else fast_counts)[0] += 1
                    step_ideal += 1.0
                    if self.profiler is not None:
                        prof_events.append((pid, pool.ptype_of(pid)))
                    pos += 1
            if self.profiler is not None:
                self.profiler.record(prof_events)

            slow_hits = (
                np.concatenate(slow_parts) if slow_parts
                else np.empty(0, np.int64)
            )
            fast_hits = (
                np.concatenate(fast_parts) if fast_parts
                else np.empty(0, np.int64)
            )

            # -- policy (uniform protocol dispatch) ------------------- #
            if ctl is not None:
                ctl.note_access_tiers(fast_counts, slow_counts)
                fast_counts[:] = 0
                slow_counts[:] = 0
            report = self.policy.step(slow_hits.tolist(), fast_hits.tolist())
            step_time += (report.demoted + report.promoted) * self.migrate_cost
            if step_no >= measure_from:
                modeled_time += step_time
                ideal_time += step_ideal
                total_accesses += len(slow_hits) + len(fast_hits)

            # -- bookkeeping ------------------------------------------ #
            vs = pool.vmstat
            step_total = len(slow_hits) + len(fast_hits)
            local_frac.append(len(fast_hits) / step_total if step_total else 1.0)
            promote_rate.append(report.promoted)
            demote_rate.append(report.demoted)
            alloc_fast_rate.append(vs.pgalloc_fast - alloc_fast_before)

            if (step_no + 1) % self.interval_steps == 0:
                pool.end_interval()  # also ticks control.note_interval
                if self.profiler is not None:
                    self.profiler.end_interval()

        return self._result(steps, total_accesses, modeled_time, ideal_time,
                            local_frac, promote_rate, demote_rate,
                            alloc_fast_rate)

    # ---------------------------------------------------------------- #
    def _result(self, steps, total_accesses, modeled_time, ideal_time,
                local_frac, promote_rate, demote_rate,
                alloc_fast_rate) -> SimResult:
        ctl = self.control
        per_tenant = self._per_tenant if self._tenant_of is not None else None
        if (per_tenant is not None and ctl is not None
                and hasattr(ctl, "promoted_total")):
            # fold the accounting ledger's migration attribution in, so
            # per-tenant counters cover the full vmstat surface (only
            # ledger-keeping controls have one — a bare TieringControl
            # passed via qos= has no per-tenant state to fold)
            for tid in range(ctl.n_tenants):
                acc = self._tenant_acc(tid)
                acc["promoted"] = int(ctl.promoted_total[tid])
                acc["demoted"] = int(ctl.demoted_total[tid])
        return SimResult(
            policy=self.policy_name,
            workload=self.workload,
            steps=steps,
            total_accesses=total_accesses,
            modeled_time=modeled_time,
            ideal_time=ideal_time,
            vmstat=self.pool.vmstat,
            local_fraction=local_frac,
            promote_rate=promote_rate,
            demote_rate=demote_rate,
            alloc_fast_rate=alloc_fast_rate,
            per_tenant=per_tenant,
            tenant_names=getattr(self.trace, "tenant_names", None),
            slow_cost=self.slow_cost,
            refault_cost=self.refault_cost,
            qos=ctl.qos_summary() if ctl is not None else None,
        )

    # ---------------------------------------------------------------- #
    def _alloc_idx(self, idx: int, ptype: PageType) -> None:
        tid = self._tenant_of(idx) if self._tenant_of is not None else 0
        try:
            page = self.pool.allocate(ptype, tenant=tid)
        except MemoryError:
            # Both tiers full: evict the coldest unpinned slow page, then
            # retry (the engine-level OOM handler).
            victim = self._coldest_slow_page()
            if victim is None:
                raise
            self.pool.evict_page(victim)
            page = self.pool.allocate(ptype, tenant=tid)
        self._pid_of[idx] = page.pid
        self._ptype_of[idx] = ptype
        if self._tenant_of is not None:
            self._tenant_acc(tid)["allocated"] += 1

    def _coldest_slow_page(self) -> Optional[int]:
        cands = self.pool.scan_reclaim_candidates(Tier.SLOW, 1)
        if cands:
            return cands[0]
        # fall back: any unpinned slow page
        return self.pool.fallback_slow_victim()


def run_policy_comparison(
    workload: str,
    fast_frames: int,
    slow_frames: int,
    steps: int = 64,
    policies: Sequence[str] = ("linux", "tpp", "numa_balancing", "autotiering"),
    seed: int = 0,
    slow_cost: float = 2.0,
    config: Optional[TppConfig] = None,
    total_pages: Optional[int] = None,
    measure_from: int = 0,
    engine: str = "reference",
    qos=None,
) -> Dict[str, SimResult]:
    """Run the same trace under each policy + the ideal baseline (Table 1).

    ``workload`` may be a single workload name or a ``+``-joined
    multi-tenant mix; ``engine`` selects the reference or vectorized
    placement engine (identical results, different speed); ``qos`` is an
    optional :class:`~repro_torch.qos.quota.QosConfig` /
    :class:`~repro_torch.qos.controller.SlowdownControllerConfig` (or ready
    :class:`~repro_torch.core.control.TieringControl`) applied to every policy
    run (the ideal baseline stays unarbitrated — it has no slow tier).
    """
    results: Dict[str, SimResult] = {}
    for pol in policies:
        sim = TieredSimulator(
            workload,
            pol,
            fast_frames,
            slow_frames,
            config=config,
            slow_cost=slow_cost,
            seed=seed,
            trace=make_trace(workload, seed=seed, total_pages=total_pages),
            engine=engine,
            qos=qos,
        )
        results[pol] = sim.run(steps, measure_from=measure_from)
    # ideal: all frames fast (sized for live peak incl. churn overshoot)
    base = total_pages or workload_total_pages(workload)
    ideal_frames = max(fast_frames + slow_frames, int(1.3 * base)) + 64
    ideal = TieredSimulator(
        workload,
        "ideal",
        ideal_frames,
        0,
        config=config,
        slow_cost=slow_cost,
        seed=seed,
        trace=make_trace(workload, seed=seed, total_pages=total_pages),
        engine=engine,
    )
    results["ideal"] = ideal.run(steps, measure_from=measure_from)
    return results
