"""Fleet-scale multi-host tiering: sharded pools + a global control plane.

Copies of the JAX package's ``repro.fleet`` modules, with the same
behaviour (NumPy and the standard library; the mesh over
``torch.distributed``):

* :class:`~repro_torch.fleet.shard.ShardPool` /
  :class:`~repro_torch.fleet.shard.HostShard` — one page pool (+ its
  :class:`~repro_torch.core.control.TieringControl`) as a
  fleet-manageable unit: a host-local fast-tier budget applied through
  ``pool.set_fast_budget`` (watermark push-down) and a telemetry window
  diffed from the control ledger's cumulative counters.  A shard is
  driven by a :class:`~repro_torch.core.simulator.TieredSimulator` or,
  for a serving engine (``ServingEngine.as_shard_pool``), by a
  :class:`~repro_torch.traffic.scheduler.TrafficScheduler`.
* :class:`~repro_torch.fleet.coordinator.FleetCoordinator` — divides ONE
  global fast-tier budget across every (host, pool) shard with the
  per-host slowdown controller's proportional law
  (:func:`~repro_torch.qos.controller.proportional_share_update`), and
  pushes integer budgets down; ``sum(budgets) == global_budget`` exactly,
  always (TierSan's fleet conservation law).
* :class:`~repro_torch.fleet.simulator.FleetSimulator` — drives N host
  shards from per-host-seeded copies of a shared workload mix, in
  ``greedy`` (static per-host split) or ``coordinated`` (periodic
  re-division) mode; ``repro_torch/benchmarks/fleet_bench.py`` compares
  the two.
* :mod:`~repro_torch.fleet.mesh` — the multi-host mesh smoke path:
  per-host telemetry rows all-reduced over a ``gloo`` group of local
  worker processes, numpy-verified.
"""

from repro_torch.fleet.coordinator import FleetCoordinator, FleetCoordinatorConfig
from repro_torch.fleet.mesh import (
    host_device_count,
    mesh_reduce_telemetry,
    request_host_devices,
)
from repro_torch.fleet.shard import HostShard, ShardPool, ShardTelemetry
from repro_torch.fleet.simulator import (
    FleetHostSpec,
    FleetPoolSpec,
    FleetResult,
    FleetSimulator,
)

__all__ = [
    "FleetCoordinator",
    "FleetCoordinatorConfig",
    "FleetHostSpec",
    "FleetPoolSpec",
    "FleetResult",
    "FleetSimulator",
    "HostShard",
    "ShardPool",
    "ShardTelemetry",
    "host_device_count",
    "mesh_reduce_telemetry",
    "request_host_devices",
]
