"""The fleet simulator: N host shards under one global fast-tier budget.

:class:`FleetSimulator` builds a rack of hosts, each running one or
more tiered pools (KV-cache-like, expert-cache-like, …) through its own
:class:`~repro_torch.core.simulator.TieredSimulator`, and steps them in
lockstep chunks of ``coordinate_every`` steps.  Two modes:

* ``greedy`` — the coordination-free baseline: the global budget is
  divided once, proportionally to physical capacity (what a per-host
  static provisioning would do), and never revisited.
* ``coordinated`` — between chunks the
  :class:`~repro_torch.fleet.coordinator.FleetCoordinator` gathers each
  shard's telemetry window and re-divides the same global budget toward
  the shards whose latency-critical tenants run hottest over SLO.

Every shard gets its *own* deterministic trace: shard ``(host h,
pool p)`` seeds its workload with ``seed + h*seed_stride + p``, so a
greedy and a coordinated fleet built from the same specs replay
byte-identical arrival sequences — the measured gap is purely the
budget policy.  Chunks are validated to be multiples of
``interval_steps`` so chunked stepping closes intervals exactly like an
unchunked run (a single-host, single-pool greedy fleet at full budget
is bit-identical to a plain ``TieredSimulator`` run — pinned by
``tests/test_torch_fleet.py``).

A copy of ``repro.fleet.simulator`` with the same behaviour; the port keeps its own
so that it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.simulator import TieredSimulator
from repro_torch.core.trace import make_trace
from repro_torch.core.types import TppConfig
from repro_torch.fleet.coordinator import FleetCoordinator, FleetCoordinatorConfig
from repro_torch.fleet.shard import HostShard, ShardPool


@dataclasses.dataclass(frozen=True)
class FleetPoolSpec:
    """One pool on one host: a workload bound to a tiered pool.

    ``qos`` is anything ``TieredSimulator(qos=...)`` accepts (a
    :class:`~repro_torch.qos.quota.QosConfig`, a
    :class:`~repro_torch.qos.controller.SlowdownControllerConfig`, or a ready
    control); ``slo`` overrides per-class slowdown targets for the
    *fleet* measurement of this pool.
    """

    name: str
    workload: str
    fast_frames: int
    slow_frames: int
    policy: str = "tpp"
    total_pages: Optional[int] = None
    config: Optional[TppConfig] = None
    qos: object = None
    slo: Optional[Mapping[str, float]] = None


@dataclasses.dataclass(frozen=True)
class FleetHostSpec:
    """One host: a tuple of pool specs sharing the host's fast tier."""

    pools: Tuple[FleetPoolSpec, ...]


@dataclasses.dataclass
class FleetResult:
    """Outcome of one fleet run (one mode, one budget)."""

    mode: str
    steps: int
    measure_from: int
    global_budget: int
    coordinate_every: int
    slow_cost: float
    refault_cost: float
    # per shard-key views
    budgets: Dict[str, int]  # final budget per shard
    vmstat: Dict[str, Dict[str, int]]  # final cumulative counters
    timelines: Dict[str, Dict[str, List]]  # per-step rates, concatenated
    tenant_windows: Dict[str, Dict[int, Dict[str, float]]]  # measured window
    tenant_classes: Dict[str, List[str]]
    coordinator: Dict  # FleetCoordinator.summary()

    # ------------------------------------------------------------ #
    # aggregate fleet metrics (the bench headline)
    # ------------------------------------------------------------ #
    def per_class(self) -> Dict[str, Dict[str, float]]:
        """Window accesses/cost/slowdown aggregated per QoS class."""
        agg: Dict[str, Dict[str, float]] = {}
        for key, window in self.tenant_windows.items():
            classes = self.tenant_classes.get(key, [])
            for tid, acc in window.items():
                cls = classes[tid] if tid < len(classes) else "standard"
                n = acc["access_fast"] + acc["access_slow"]
                cost = (acc["access_fast"]
                        + acc["access_slow"] * self.slow_cost
                        + acc.get("refaults", 0) * self.refault_cost)
                slot = agg.setdefault(cls, {"accesses": 0.0, "cost": 0.0})
                slot["accesses"] += n
                slot["cost"] += cost
        for slot in agg.values():
            slot["slowdown"] = (
                round(slot["cost"] / slot["accesses"], 4)
                if slot["accesses"] else 1.0
            )
        return agg

    def aggregate_slowdown(self, qos_class: Optional[str] = None) -> float:
        """Access-weighted modeled slowdown over the measured window.

        ``qos_class=None`` aggregates every tenant in the fleet;
        otherwise only tenants of that class (1.0 when none ran).
        """
        agg = self.per_class()
        if qos_class is not None:
            slot = agg.get(qos_class)
            return float(slot["slowdown"]) if slot else 1.0
        acc = sum(s["accesses"] for s in agg.values())
        cost = sum(s["cost"] for s in agg.values())
        return round(cost / acc, 4) if acc else 1.0

    @property
    def lc_slowdown(self) -> float:
        """Aggregate latency-critical slowdown (the headline metric)."""
        return self.aggregate_slowdown("latency_critical")

    def tenant_slowdowns(self) -> Dict[str, float]:
        """Window slowdown per (shard, tenant), keyed ``h0/kv:2``."""
        out: Dict[str, float] = {}
        for key, window in sorted(self.tenant_windows.items()):
            for tid, acc in sorted(window.items()):
                n = acc["access_fast"] + acc["access_slow"]
                cost = (acc["access_fast"]
                        + acc["access_slow"] * self.slow_cost
                        + acc.get("refaults", 0) * self.refault_cost)
                out[f"{key}:{tid}"] = round(cost / n, 4) if n else 1.0
        return out

    def jains_fairness(self) -> Optional[float]:
        """Jain's index over fleet-wide per-tenant throughput."""
        slow = self.tenant_slowdowns()
        if not slow:
            return None
        x = np.asarray([1.0 / v for v in slow.values()], np.float64)
        return round(float((x.sum() ** 2) / (len(x) * (x * x).sum())), 4)

    def summary(self) -> Dict:
        return {
            "mode": self.mode,
            "steps": self.steps,
            "global_budget": self.global_budget,
            "aggregate_slowdown": self.aggregate_slowdown(),
            "lc_slowdown": self.lc_slowdown,
            "per_class": self.per_class(),
            "jains_index": self.jains_fairness(),
            "budgets": dict(self.budgets),
            "coordinator_ticks": self.coordinator.get("ticks", 0),
        }


class FleetSimulator:
    """Drive N host shards from per-host-seeded copies of one mix."""

    MODES = ("greedy", "coordinated")

    def __init__(
        self,
        hosts: Sequence,
        mode: str = "coordinated",
        global_fast_budget: Optional[int] = None,
        coordinate_every: int = 16,
        interval_steps: int = 4,
        seed: int = 0,
        seed_stride: int = 1000,
        slow_cost: float = 2.0,
        migrate_cost: float = 0.05,
        refault_cost: float = 50.0,
        engine: str = "vectorized",
        coordinator: Optional[FleetCoordinatorConfig] = None,
    ) -> None:
        if mode not in self.MODES:
            raise ValueError(f"unknown mode {mode!r}; choose from {self.MODES}")
        if interval_steps < 1 or coordinate_every < 1 \
                or coordinate_every % interval_steps:
            raise ValueError(
                f"coordinate_every ({coordinate_every}) must be a positive "
                f"multiple of interval_steps ({interval_steps}): chunk "
                f"boundaries must close intervals exactly like an "
                f"unchunked run"
            )
        self.mode = mode
        self.coordinate_every = int(coordinate_every)
        self.interval_steps = int(interval_steps)
        self.seed = int(seed)
        self.seed_stride = int(seed_stride)
        self.slow_cost = float(slow_cost)
        self.refault_cost = float(refault_cost)

        self.hosts: List[HostShard] = []
        self.pools: List[ShardPool] = []
        for h, host_spec in enumerate(hosts):
            pool_specs = (
                host_spec.pools if isinstance(host_spec, FleetHostSpec)
                else tuple(host_spec)
            )
            shard = HostShard(h)
            for p, spec in enumerate(pool_specs):
                shard_seed = self.shard_seed(h, p)
                sim = TieredSimulator(
                    spec.workload,
                    spec.policy,
                    spec.fast_frames,
                    spec.slow_frames,
                    config=spec.config,
                    slow_cost=slow_cost,
                    migrate_cost=migrate_cost,
                    refault_cost=refault_cost,
                    interval_steps=interval_steps,
                    seed=shard_seed,
                    trace=make_trace(
                        spec.workload, seed=shard_seed,
                        total_pages=spec.total_pages,
                    ),
                    engine=engine,
                    qos=spec.qos,
                )
                shard.register(ShardPool(
                    host=h, name=spec.name, pool=sim.pool,
                    control=sim.control, sim=sim, slo=spec.slo,
                    slow_cost=slow_cost,
                ))
            if not shard.pools:
                raise ValueError(f"host {h} has no pools")
            self.hosts.append(shard)
            self.pools.extend(shard.pools)

        physical = sum(p.physical_fast for p in self.pools)
        self.global_budget = int(
            global_fast_budget if global_fast_budget is not None else physical
        )
        self.coordinator = FleetCoordinator(
            self.pools, self.global_budget, config=coordinator
        )
        # Both modes start from the identical capacity-proportional
        # static division — greedy keeps it forever, coordinated
        # re-divides each chunk.  (At full budget this push is a no-op,
        # which is what keeps the single-host parity bit-identical.)
        self.coordinator.push(self.coordinator.initial_budgets())

    def shard_seed(self, host: int, pool_index: int) -> int:
        """Deterministic per-shard trace seed (reproducible fleets)."""
        return self.seed + host * self.seed_stride + pool_index

    # ---------------------------------------------------------------- #
    def run(self, steps: int, measure_from: int = 0) -> FleetResult:
        """Run the fleet ``steps`` steps; measure from ``measure_from``.

        ``steps`` must be a multiple of ``interval_steps`` and
        ``measure_from`` a chunk boundary (a multiple of
        ``coordinate_every``) so the measurement window opens exactly
        between chunks in both modes.
        """
        if steps < 1 or steps % self.interval_steps:
            raise ValueError(
                f"steps ({steps}) must be a positive multiple of "
                f"interval_steps ({self.interval_steps})"
            )
        if measure_from and (measure_from % self.coordinate_every
                             or measure_from >= steps):
            raise ValueError(
                f"measure_from ({measure_from}) must be a chunk boundary "
                f"(multiple of coordinate_every={self.coordinate_every}) "
                f"below steps ({steps})"
            )
        timelines: Dict[str, Dict[str, List]] = {
            p.key: {"local_fraction": [], "promote_rate": [],
                    "demote_rate": [], "alloc_fast_rate": []}
            for p in self.pools
        }
        snaps = self._snapshot() if measure_from == 0 else None
        done = 0
        while done < steps:
            chunk = min(self.coordinate_every, steps - done)
            for sp in self.pools:
                res = sp.sim.run(chunk)
                tl = timelines[sp.key]
                tl["local_fraction"].extend(res.local_fraction)
                tl["promote_rate"].extend(res.promote_rate)
                tl["demote_rate"].extend(res.demote_rate)
                tl["alloc_fast_rate"].extend(res.alloc_fast_rate)
            done += chunk
            if snaps is None and done >= measure_from:
                snaps = self._snapshot()
            if self.mode == "coordinated" and done < steps:
                self.coordinator.tick()
        self.coordinator.check_conservation()

        windows: Dict[str, Dict[int, Dict[str, float]]] = {}
        classes: Dict[str, List[str]] = {}
        for sp in self.pools:
            windows[sp.key] = self._window(
                snaps.get(sp.key, {}), sp.sim.tenant_counters()
            )
            classes[sp.key] = sp.classes()
        return FleetResult(
            mode=self.mode,
            steps=steps,
            measure_from=measure_from,
            global_budget=self.global_budget,
            coordinate_every=self.coordinate_every,
            slow_cost=self.slow_cost,
            refault_cost=self.refault_cost,
            budgets={p.key: p.budget for p in self.pools},
            vmstat={p.key: p.pool.vmstat.as_dict() for p in self.pools},
            timelines=timelines,
            tenant_windows=windows,
            tenant_classes=classes,
            coordinator=self.coordinator.summary(),
        )

    # ---------------------------------------------------------------- #
    def _snapshot(self) -> Dict[str, Dict[int, Dict[str, int]]]:
        return {p.key: p.sim.tenant_counters() for p in self.pools}

    @staticmethod
    def _window(
        before: Dict[int, Dict[str, int]], after: Dict[int, Dict[str, int]]
    ) -> Dict[int, Dict[str, float]]:
        """Per-tenant counter deltas between two cumulative snapshots."""
        out: Dict[int, Dict[str, float]] = {}
        for tid, acc in after.items():
            prev = before.get(tid, {})
            out[tid] = {k: v - prev.get(k, 0) for k, v in acc.items()}
        return out
