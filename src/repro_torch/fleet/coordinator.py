"""The fleet coordinator: one fast-tier budget, divided across shards.

:class:`FleetCoordinator` owns a single global fast-tier budget and
re-divides it across every (host, pool) shard on each :meth:`tick`:

1. **gather** — every shard reports one telemetry window
   (:meth:`~repro_torch.fleet.shard.ShardPool.telemetry`): access-weighted
   modeled slowdown vs its tenants' SLO targets, as a *pressure* ratio
   (1.0 = on target).
2. **re-divide** — shard shares take one Equilibria-style proportional
   step on the EWMA-smoothed pressures
   (:func:`~repro_torch.qos.controller.proportional_share_update` — literally
   the same control law the per-host slowdown controller applies to
   tenant shares, lifted one altitude).
3. **push** — shares become *integer* frame budgets by largest-remainder
   rounding clamped to ``[min_budget, physical]``, with
   ``sum(budgets) == global_budget`` exact (the fleet conservation law
   TierSan checks), and land on each shard via
   ``pool.set_fast_budget`` (watermark + quota push-down).

The coordinator never moves pages itself — it only moves *watermarks
and quotas*; each host's own reclaim/promotion machinery (and QoS
arbiter, if any) does the actual migration toward the new budget.  That
mirrors how a real fleet controller must operate: the data plane is
host-local, only the budget is global.

A copy of ``repro.fleet.coordinator`` with the same behaviour; the port keeps its own
so that it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.fleet.mesh import mesh_reduce_telemetry
from repro_torch.fleet.shard import ShardPool, ShardTelemetry
from repro_torch.qos.controller import proportional_share_update


@dataclasses.dataclass(frozen=True)
class FleetCoordinatorConfig:
    """Tunables of the fleet budget controller.

    * ``gain`` — proportional gain on the relative pressure error per
      tick (same semantics as the slowdown controller's).
    * ``share_floor`` — minimum global-budget share any shard keeps.
    * ``min_budget`` — hard per-shard frame floor (≥ 4: the watermark
      scheme needs a few budgeted frames to be meaningful).
    * ``measure_alpha`` — EWMA smoothing over per-tick pressures.
    * ``use_mesh`` — all-reduce the per-host telemetry rows over a
      ``gloo`` group of local processes
      (:func:`~repro_torch.fleet.mesh.mesh_reduce_telemetry`) for the
      fleet-pressure aggregate, falling back to numpy when the group has
      fewer ranks than hosts.  The budgets themselves are always
      computed identically — the mesh path is the multi-host smoke
      surface, numpy-verified in tests.
    * ``miss_decay`` — per-missed-tick decay of the shares toward the
      greedy capacity-proportional static split (see
      :meth:`FleetCoordinator.missed_tick`).  1.0 snaps back to greedy
      in one miss; small values forget the learned skew slowly.
    """

    gain: float = 0.5
    share_floor: float = 0.02
    min_budget: int = 8
    measure_alpha: float = 0.5
    use_mesh: bool = False
    miss_decay: float = 0.25

    def __post_init__(self) -> None:
        if self.gain <= 0:
            raise ValueError("gain must be positive")
        if self.min_budget < 4:
            raise ValueError(
                f"min_budget must be >= 4 (watermarks need a few budgeted "
                f"frames; got {self.min_budget})"
            )
        if not 0 < self.share_floor < 1:
            raise ValueError("share_floor must be in (0, 1)")
        if not 0 < self.miss_decay <= 1:
            raise ValueError(
                f"miss_decay must be in (0, 1] (got {self.miss_decay})"
            )


class FleetCoordinator:
    """Divide one global fast-tier budget across shard pools."""

    def __init__(
        self,
        pools: Sequence[ShardPool],
        global_budget: int,
        config: Optional[FleetCoordinatorConfig] = None,
    ) -> None:
        if not pools:
            raise ValueError("a fleet needs at least one shard pool")
        keys = [p.key for p in pools]
        if len(set(keys)) != len(keys):
            raise ValueError(f"duplicate shard keys: {sorted(keys)}")
        self.config = config or FleetCoordinatorConfig()
        self.pools: List[ShardPool] = list(pools)
        n = len(self.pools)
        self._physical = np.asarray(
            [p.physical_fast for p in self.pools], np.int64
        )
        lo = n * self.config.min_budget
        hi = int(self._physical.sum())
        if (self._physical < self.config.min_budget).any():
            small = [p.key for p in self.pools
                     if p.physical_fast < self.config.min_budget]
            raise ValueError(
                f"shards {small} have fewer physical fast frames than "
                f"min_budget={self.config.min_budget}"
            )
        if not lo <= int(global_budget) <= hi:
            raise ValueError(
                f"global fast budget {global_budget} outside "
                f"[{lo}, {hi}] (= n_shards*min_budget .. sum physical)"
            )
        self.global_budget = int(global_budget)
        # shares start proportional to physical capacity — the "greedy"
        # static division a coordination-free fleet would provision
        self.shares = self._physical / self._physical.sum()
        self.pressure_ewma = np.ones(n, np.float64)
        self.ticks = 0
        self.missed_ticks = 0
        self.timeline: List[Dict] = []

    # ---------------------------------------------------------------- #
    # integer division of the global budget
    # ---------------------------------------------------------------- #
    def divide(self) -> np.ndarray:
        """Shares → integer frame budgets; exact sum, clamped per shard.

        Largest-remainder rounding, then deterministic one-frame
        round-robin correction against the ``[min_budget, physical]``
        clamps.  Terminates because the constructor pinned
        ``global_budget`` inside the feasible interval.
        """
        cfg = self.config
        raw = self.shares * self.global_budget
        base = np.clip(
            np.floor(raw).astype(np.int64), cfg.min_budget, self._physical
        )
        diff = self.global_budget - int(base.sum())
        order = np.argsort(-(raw - base), kind="stable")
        while diff != 0:
            moved = False
            for i in (order if diff > 0 else order[::-1]):
                if diff > 0 and base[i] < self._physical[i]:
                    base[i] += 1
                    diff -= 1
                    moved = True
                elif diff < 0 and base[i] > cfg.min_budget:
                    base[i] -= 1
                    diff += 1
                    moved = True
                if diff == 0:
                    break
            if not moved:  # pragma: no cover - excluded by ctor validation
                raise AssertionError(
                    "fleet budget division cannot satisfy clamps"
                )
        return base

    def push(self, budgets: np.ndarray) -> None:
        """Apply a division to every shard (watermark + quota updates)."""
        for pool, b in zip(self.pools, budgets):
            pool.apply_budget(int(b))
        self.check_conservation()

    def initial_budgets(self) -> np.ndarray:
        """The static division from the capacity-proportional shares."""
        return self.divide()

    # ---------------------------------------------------------------- #
    # the control loop
    # ---------------------------------------------------------------- #
    def tick(self) -> List[ShardTelemetry]:
        """Gather one telemetry window, re-divide, push budgets down."""
        telem = [p.telemetry() for p in self.pools]
        measured = np.asarray([t.pressure for t in telem], np.float64)
        a = self.config.measure_alpha
        self.pressure_ewma = (1.0 - a) * self.pressure_ewma + a * measured
        self.shares = proportional_share_update(
            self.shares,
            self.pressure_ewma,
            np.ones(len(self.pools), np.float64),
            self.config.gain,
            self.config.share_floor,
        )
        budgets = self.divide()
        self.push(budgets)
        self.ticks += 1
        self.timeline.append({
            "tick": self.ticks,
            "pressures": [round(float(x), 4) for x in measured],
            "shares": [round(float(s), 4) for s in self.shares],
            "budgets": [int(b) for b in budgets],
            "fleet_pressure": round(self._fleet_pressure(telem), 4),
        })
        return telem

    def missed_tick(self) -> np.ndarray:
        """Fault tolerance: a gather round failed (telemetry unreachable).

        A coordinator that keeps pushing stale learned skew while blind
        can starve a shard whose load spiked after the last good window.
        Instead each missed round decays the shares — and the pressure
        EWMA, which carries no fresh information either — toward the
        greedy capacity-proportional static split a coordination-free
        fleet would provision (``miss_decay`` per miss); repeated misses
        converge on that safe division, and the first successful
        :meth:`tick` resumes control from wherever the decay left off.
        Budgets still re-divide and push (conservation holds throughout).
        """
        d = self.config.miss_decay
        greedy = self._physical / self._physical.sum()
        self.shares = (1.0 - d) * self.shares + d * greedy
        self.pressure_ewma = (1.0 - d) * self.pressure_ewma + d
        budgets = self.divide()
        self.push(budgets)
        self.ticks += 1
        self.missed_ticks += 1
        self.timeline.append({
            "tick": self.ticks,
            "missed": True,
            "shares": [round(float(s), 4) for s in self.shares],
            "budgets": [int(b) for b in budgets],
        })
        return budgets

    def _fleet_pressure(self, telem: List[ShardTelemetry]) -> float:
        """Access-weighted fleet-wide pressure for the tick record.

        Per-host rows ``[accesses, cost, weighted-target]`` are summed
        across hosts — through the ``gloo`` mesh when ``use_mesh`` (the
        multi-host smoke path), else plain numpy; both reduce to the
        identical global row.
        """
        hosts = sorted({t.host for t in telem})
        rows = np.zeros((len(hosts), 3), np.float64)
        for t in telem:
            h = hosts.index(t.host)
            rows[h] += (t.accesses, t.measured * t.accesses,
                        t.target * t.accesses)
        total = None
        if self.config.use_mesh:
            total = mesh_reduce_telemetry(rows)
        if total is None:
            total = rows.sum(axis=0)
        if total[0] <= 0 or total[2] <= 0:
            return 1.0
        return float(total[1] / total[2])

    # ---------------------------------------------------------------- #
    # invariants
    # ---------------------------------------------------------------- #
    def check_conservation(self) -> None:
        """The fleet conservation law: budgets sum to the global budget
        exactly and respect every shard's clamps.  Raises AssertionError
        on violation (TierSan's fleet law calls this)."""
        budgets = np.asarray([p.budget for p in self.pools], np.int64)
        assert int(budgets.sum()) == self.global_budget, (
            f"fleet budget leak: shard budgets sum to {int(budgets.sum())}, "
            f"global budget is {self.global_budget}"
        )
        bad_lo = budgets < self.config.min_budget
        bad_hi = budgets > self._physical
        assert not bad_lo.any() and not bad_hi.any(), (
            f"shard budget outside clamps: "
            f"{[(p.key, int(b)) for p, b in zip(self.pools, budgets)]}"
        )

    def summary(self) -> Dict:
        return {
            "global_budget": self.global_budget,
            "ticks": self.ticks,
            "missed_ticks": self.missed_ticks,
            "shards": [
                {
                    "key": p.key,
                    "budget": p.budget,
                    "physical_fast": p.physical_fast,
                    "share": round(float(s), 4),
                    "pressure_ewma": round(float(e), 4),
                }
                for p, s, e in zip(
                    self.pools, self.shares, self.pressure_ewma
                )
            ],
            "timeline": [dict(e) for e in self.timeline],
        }
