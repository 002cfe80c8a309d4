"""Table 1 — application throughput normalized to the all-fast ideal.

Paper: TPP ≈ ideal (<1% gap), up to +18% over default Linux, +5-17%
over NUMA Balancing / AutoTiering.  We reproduce the comparison matrix
(policies × workloads × {2:1, 1:4}) on the trace simulator with the
real pool/LRU/policy mechanism.

Counterpart of ``benchmarks/table1_throughput.py`` over
:mod:`repro_torch.core`: the lines equal the JAX suite's but for the
timing column.
"""

from __future__ import annotations

import time
from typing import List

from repro_torch.benchmarks.common import (
    GEOM, MEASURE_FROM, MEM_STALL_FRAC, POLICIES, POLICY_CFG, SEED,
    SLOW_COST, STEPS,
)
from repro_torch.core import run_policy_comparison

# paper Table 1 rows: (workload, config)
ROWS = [
    ("web", "2:1"),
    ("cache1", "2:1"),
    ("cache1", "1:4"),
    ("cache2", "2:1"),
    ("cache2", "1:4"),
    ("data_warehouse", "2:1"),
]


def run(quick: bool = False, engine: str = "reference") -> List[str]:
    steps = 80 if quick else STEPS
    measure = 50 if quick else MEASURE_FROM
    out = []
    for workload, geom in ROWS:
        fast, slow, total = GEOM[geom]
        t0 = time.time()
        res = run_policy_comparison(
            workload, fast, slow, steps=steps, policies=POLICIES,
            seed=SEED, slow_cost=SLOW_COST, config=POLICY_CFG,
            total_pages=total, measure_from=measure, engine=engine,
        )
        dt_us = (time.time() - t0) * 1e6 / steps
        for pol in (*POLICIES, "ideal"):
            r = res[pol]
            r.mem_stall_frac = MEM_STALL_FRAC
            out.append(
                f"table1/{workload}_{geom}/{pol},{dt_us:.1f},"
                f"tput={r.throughput_vs_ideal:.4f};raw={r.raw_throughput_vs_ideal:.4f};"
                f"local={r.mean_local_fraction:.3f};demoted={r.vmstat.pgdemote_total};"
                f"promoted={r.vmstat.pgpromote_total};pingpong={r.vmstat.ping_pong_rate:.3f}"
            )
    return out


if __name__ == "__main__":
    for line in run():
        print(line)
