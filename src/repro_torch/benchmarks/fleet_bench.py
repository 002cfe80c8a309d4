"""Fleet tiering benchmark — greedy static split vs the coordinator.

Counterpart of ``benchmarks/fleet_bench.py`` over the port's
:mod:`repro_torch.fleet`.  A 4-host, 2-pool-per-host fleet shares ONE
fast-tier budget (45% of the fleet's physical fast capacity).  Hosts are
deliberately skewed the way a real region is:

* hosts 0-1 ("frontend") run a latency-critical KV pool
  (``web+cache1``) next to a batch warehouse pool;
* hosts 2-3 ("batch") run a standard cache pool next to churny
  warehouse jobs — no latency-critical tenant anywhere.

``greedy`` divides the global budget once, proportionally to physical
capacity; ``coordinated`` re-divides the same budget every
``COORDINATE_EVERY`` steps from measured shard pressure
(access-weighted slowdown vs per-class SLO).  Headline: aggregate
latency-critical slowdown across the fleet drops under coordination at
the *same* global budget.  The coordinated run also exercises the
multi-host mesh smoke path (per-host telemetry all-reduced over a
4-rank ``gloo`` group of local processes).

The fleet is host-only: it takes no device.  The numbers equal the JAX
benchmark's (``tests/test_torch_fleet.py``).  The JSON is written only to
the path ``--out`` names.

  PYTHONPATH=src python -m repro_torch.benchmarks.fleet_bench --quick
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.core import TppConfig
from repro_torch.fleet import (
    FleetCoordinatorConfig,
    FleetHostSpec,
    FleetPoolSpec,
    FleetSimulator,
    request_host_devices,
)
from repro_torch.qos import QosConfig

N_HOSTS = 4
FAST_FRAMES = 160  # physical fast frames per pool
SLOW_FRAMES = 900
TOTAL_PAGES = 800
GLOBAL_BUDGET_FRACTION = 0.45  # the fleet bought under half the physical fast
STEPS = 160
MEASURE_FROM = 64
QUICK_STEPS = 64
QUICK_MEASURE_FROM = 16
COORDINATE_EVERY = 16
INTERVAL_STEPS = 4
SLOW_COST = 3.0
SEED = 1
CFG = TppConfig(demote_budget=256, promote_budget=128, sample_rate=0.1)
COORD = FleetCoordinatorConfig(gain=0.8, measure_alpha=0.6, use_mesh=True)


def _pool(name: str, workload: str, classes) -> FleetPoolSpec:
    return FleetPoolSpec(
        name=name, workload=workload, fast_frames=FAST_FRAMES,
        slow_frames=SLOW_FRAMES, total_pages=TOTAL_PAGES, config=CFG,
        qos=QosConfig(classes=tuple(classes),
                      promote_tokens_per_interval=128.0),
    )


def fleet_hosts() -> List[FleetHostSpec]:
    frontend = FleetHostSpec(pools=(
        _pool("kv", "web+cache1", ("latency_critical", "standard")),
        _pool("warehouse", "data_warehouse+ads", ("batch", "batch")),
    ))
    batch = FleetHostSpec(pools=(
        _pool("kv", "cache2+ads", ("standard", "batch")),
        _pool("warehouse", "data_warehouse+data_warehouse",
              ("batch", "batch")),
    ))
    return [frontend, frontend, batch, batch][:N_HOSTS]


def _run(mode: str, steps: int, measure_from: int, engine: str):
    request_host_devices(N_HOSTS)  # the mesh spans the fleet's hosts
    hosts = fleet_hosts()
    physical = 2 * len(hosts) * FAST_FRAMES
    fleet = FleetSimulator(
        hosts,
        mode=mode,
        global_fast_budget=int(physical * GLOBAL_BUDGET_FRACTION),
        coordinate_every=COORDINATE_EVERY,
        interval_steps=INTERVAL_STEPS,
        seed=SEED,
        slow_cost=SLOW_COST,
        engine=engine,
        coordinator=COORD,
    )
    return fleet, fleet.run(steps, measure_from=measure_from)


def run(quick: bool = False, engine: str = "vectorized",
        out: Optional[str] = None) -> List[str]:
    """Both modes over the same fleet; writes the JSON to ``out`` when
    given."""
    steps = QUICK_STEPS if quick else STEPS
    measure_from = QUICK_MEASURE_FROM if quick else MEASURE_FROM

    lines: List[str] = []
    results: Dict[str, Dict] = {}
    for mode in ("greedy", "coordinated"):
        fleet, res = _run(mode, steps, measure_from, engine)
        fleet.coordinator.check_conservation()
        summary = res.summary()
        results[mode] = {
            **summary,
            "per_pool_local_fraction": {
                k: round(sum(tl["local_fraction"]) /
                         max(1, len(tl["local_fraction"])), 4)
                for k, tl in res.timelines.items()
            },
            "coordinator_timeline": res.coordinator["timeline"],
        }
        lines.append(f"fleet/{mode}_lc_slowdown,0.0,x{res.lc_slowdown:.3f}")
        lines.append(
            f"fleet/{mode}_agg_slowdown,0.0,x{res.aggregate_slowdown():.3f}"
        )
        lines.append(f"fleet/{mode}_jain,0.0,{res.jains_fairness():.4f}")

    lc_g = results["greedy"]["lc_slowdown"]
    lc_c = results["coordinated"]["lc_slowdown"]
    improvement = round((lc_g - lc_c) / lc_g, 4)
    lines.append(f"fleet/lc_improvement,0.0,{improvement:.1%}")

    if out is not None:
        with open(out, "w") as f:
            json.dump({
                "hosts": N_HOSTS,
                "pools_per_host": 2,
                "fast_frames_per_pool": FAST_FRAMES,
                "slow_frames_per_pool": SLOW_FRAMES,
                "global_budget": int(
                    2 * N_HOSTS * FAST_FRAMES * GLOBAL_BUDGET_FRACTION),
                "coordinate_every": COORDINATE_EVERY,
                "steps": steps,
                "measure_from": measure_from,
                "slow_cost": SLOW_COST,
                "engine": engine,
                "coordinator": {
                    "gain": COORD.gain,
                    "share_floor": COORD.share_floor,
                    "min_budget": COORD.min_budget,
                    "measure_alpha": COORD.measure_alpha,
                    "use_mesh": COORD.use_mesh,
                },
                "results": results,
                "latency_critical_slowdown": {
                    "greedy": lc_g,
                    "coordinated": lc_c,
                    "improvement": improvement,
                },
            }, f, indent=2)
    return lines


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help=f"{QUICK_STEPS} steps, not {STEPS}")
    ap.add_argument("--out", metavar="PATH", help="write the JSON results here")
    args = ap.parse_args()
    for line in run(quick=args.quick, out=args.out):
        print(line)
