"""Host shards: page pools wrapped as fleet-manageable units.

A *shard* is one (host, pool) pair the fleet coordinator can budget:
a page pool (either engine) plus its attached
:class:`~repro_torch.core.control.TieringControl`.  The shard contributes two
things to the fleet control plane:

* **budget push-down** — :meth:`ShardPool.apply_budget` forwards to
  ``pool.set_fast_budget``, which shifts the TPP watermarks up by the
  reserved frames (shrinking the *effective* fast tier to the budget —
  background reclaim demotes down to it, promotions refill up to it)
  and re-divides the control's tenant quotas over the new capacity.
* **telemetry windows** — :meth:`ShardPool.telemetry` diffs the control
  ledger's *cumulative* counters against the previous call, so the
  coordinator's measurement window is exactly one coordination period
  regardless of the interval cadence underneath.

The window measurement is the same modeled-slowdown estimate the
per-host slowdown controller uses (``(fast + slow_cost·slow) /
accesses``, ideal all-fast = 1.0), aggregated access-weighted across
the shard's tenants against their per-class SLO targets.  A shard whose
control keeps no ledger (``NullControl``) reports *on-target* — the
coordinator holds its share rather than inventing a pressure signal.

A copy of ``repro.fleet.shard`` with the same behaviour; the port keeps its own
so that it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.types import Tier
from repro_torch.qos.controller import DEFAULT_SLO


@dataclasses.dataclass
class ShardTelemetry:
    """One measurement window of one shard, as the coordinator sees it.

    ``pressure = measured / target`` is the coordinator's error signal:
    1.0 = the shard's tenants sit exactly on their access-weighted SLO;
    above = under-budgeted (slower than target), below = over-budgeted.
    """

    host: int
    name: str
    key: str  # "h<host>/<name>"
    budget: int
    physical_fast: int
    fast_free: int
    accesses: int  # window total (fast + slow)
    measured: float  # access-weighted modeled slowdown (ideal = 1.0)
    target: float  # access-weighted SLO target
    pressure: float  # measured / target
    # per-class window accounting, for fleet-level aggregation:
    # class -> {"accesses": int, "cost": float}
    per_class: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict
    )
    # window migration / arbitration deltas (observability)
    promoted: int = 0
    demoted: int = 0
    denied: int = 0
    steered: int = 0
    shed: int = 0


def _pad_to(arr: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad a previous-snapshot array to a grown tenant count."""
    if len(arr) >= n:
        return arr
    return np.concatenate([arr, np.zeros(n - len(arr), arr.dtype)])


class ShardPool:
    """One (host, pool) fleet unit: budget target + telemetry window.

    ``control`` defaults to ``pool.control``; ``sim`` optionally carries
    the :class:`~repro_torch.core.simulator.TieredSimulator` driving the pool
    (the fleet simulator steps shards through it), and ``traffic`` a
    :class:`~repro_torch.traffic.scheduler.TrafficScheduler` — a shard whose
    pool serves live request traffic instead of a synthetic access
    stream (:meth:`HostShard.step` advances whichever one is
    attached).  ``slo`` maps class names to slowdown targets (default
    :data:`~repro_torch.qos.controller.DEFAULT_SLO`); ``slow_cost`` must match
    the modeled slow-tier cost of whatever drives the pool so measured
    slowdowns are comparable.
    """

    def __init__(
        self,
        host: int,
        name: str,
        pool,
        control=None,
        sim=None,
        traffic=None,
        slo: Optional[Mapping[str, float]] = None,
        slow_cost: float = 2.0,
    ) -> None:
        self.host = int(host)
        self.name = str(name)
        self.pool = pool
        self.control = control if control is not None else pool.control
        self.sim = sim
        self.traffic = traffic
        self.slo = dict(DEFAULT_SLO)
        if slo:
            self.slo.update(slo)
        self.slow_cost = float(slow_cost)
        self.physical_fast = int(pool.num_frames[Tier.FAST])
        self.budget = int(getattr(pool, "fast_budget", self.physical_fast))
        self._prev: Optional[Dict[str, np.ndarray]] = None
        self._prev_scalars: Dict[str, int] = {}

    @property
    def key(self) -> str:
        return f"h{self.host}/{self.name}"

    # ---------------------------------------------------------------- #
    # budget push-down
    # ---------------------------------------------------------------- #
    def apply_budget(self, budget: int) -> None:
        """Push a new fast-tier budget down to the pool + its control."""
        budget = int(budget)
        if budget != self.budget:
            self.pool.set_fast_budget(budget)
            self.budget = budget

    # ---------------------------------------------------------------- #
    # tenant classes (for per-class aggregation)
    # ---------------------------------------------------------------- #
    def classes(self) -> List[str]:
        cls = getattr(self.control, "classes", None)
        if cls is not None:
            return list(cls)
        n = getattr(self.control, "n_tenants", 1)
        return ["standard"] * int(n)

    # ---------------------------------------------------------------- #
    # telemetry window
    # ---------------------------------------------------------------- #
    def telemetry(self) -> ShardTelemetry:
        """Measure the window since the previous call (cumulative diffs).

        The first call measures from shard creation.  A ledger-free
        control yields an empty window, which reports *on-target*
        (``pressure = 1.0``) — no signal, no share movement.
        """
        snap = None
        fleet_telemetry = getattr(self.control, "fleet_telemetry", None)
        if fleet_telemetry is not None:
            snap = fleet_telemetry()
        out = ShardTelemetry(
            host=self.host, name=self.name, key=self.key,
            budget=self.budget, physical_fast=self.physical_fast,
            fast_free=int(self.pool.free_frames(Tier.FAST)),
            accesses=0, measured=1.0, target=1.0, pressure=1.0,
        )
        if snap is None:
            return out

        classes = snap.get("classes") or self.classes()
        n = len(snap["access_fast"])
        classes = (list(classes) + ["standard"] * n)[:n]
        prev = self._prev or {}
        fast_d = snap["access_fast"] - _pad_to(
            prev.get("access_fast", np.zeros(0, np.int64)), n)
        slow_d = snap["access_slow"] - _pad_to(
            prev.get("access_slow", np.zeros(0, np.int64)), n)
        prom_d = snap["promoted"] - _pad_to(
            prev.get("promoted", np.zeros(0, np.int64)), n)
        dem_d = snap["demoted"] - _pad_to(
            prev.get("demoted", np.zeros(0, np.int64)), n)
        self._prev = {k: v for k, v in snap.items()
                      if isinstance(v, np.ndarray)}

        acc = (fast_d + slow_d).astype(np.float64)
        cost = fast_d + self.slow_cost * slow_d.astype(np.float64)
        slo_t = np.asarray(
            [float(self.slo.get(c, self.slo["standard"])) for c in classes]
        )
        total = float(acc.sum())
        out.accesses = int(total)
        out.promoted = int(prom_d.sum())
        out.demoted = int(dem_d.sum())
        if total > 0:
            out.measured = float(cost.sum() / total)
            out.target = float((acc * slo_t).sum() / total)
            out.pressure = out.measured / out.target
        for c in sorted(set(classes)):
            sel = np.asarray([cl == c for cl in classes])
            out.per_class[c] = {
                "accesses": int(acc[sel].sum()),
                "cost": float(cost[sel].sum()),
            }
        # arbitration deltas (arbiter-only scalars; diffed like the rest)
        for field, key_ in (("steered", "steered_total"),
                            ("shed", "shed_total")):
            cur = snap.get(key_)
            if cur is not None:
                setattr(out, field, int(cur) - self._prev_scalars.get(key_, 0))
                self._prev_scalars[key_] = int(cur)
        denied = 0
        for key_ in ("denied_quota", "denied_token"):
            cur = snap.get(key_)
            if cur is not None:
                cur_sum = int(np.sum(cur))
                denied += cur_sum - self._prev_scalars.get(key_, 0)
                self._prev_scalars[key_] = cur_sum
        out.denied = denied
        return out


class HostShard:
    """One host: its shard pools + the host-level budget view."""

    def __init__(self, host: int, pools: Sequence[ShardPool] = ()) -> None:
        self.host = int(host)
        self.pools: List[ShardPool] = []
        for p in pools:
            self.register(p)

    def register(self, pool: ShardPool) -> None:
        if pool.host != self.host:
            raise ValueError(
                f"shard {pool.key!r} belongs to host {pool.host}, "
                f"not host {self.host}"
            )
        if any(p.name == pool.name for p in self.pools):
            raise ValueError(f"duplicate pool name {pool.name!r} on "
                             f"host {self.host}")
        self.pools.append(pool)

    @property
    def budget(self) -> int:
        """The host's fast-tier budget (sum of its pools' budgets)."""
        return sum(p.budget for p in self.pools)

    @property
    def physical_fast(self) -> int:
        return sum(p.physical_fast for p in self.pools)

    def telemetry(self) -> List[ShardTelemetry]:
        return [p.telemetry() for p in self.pools]

    def step(self, steps: int) -> Dict[str, object]:
        """Advance every driven pool ``steps`` steps.

        Simulator shards run their synthetic access stream; traffic
        shards run up to ``steps`` generate steps of their scheduler
        (the run is incremental — the next call continues the same
        trace where this one stopped).
        """
        out: Dict[str, object] = {}
        for p in self.pools:
            if p.sim is not None:
                out[p.key] = p.sim.run(steps)
            elif p.traffic is not None:
                out[p.key] = p.traffic.run(max_steps=steps).summary()
        return out
