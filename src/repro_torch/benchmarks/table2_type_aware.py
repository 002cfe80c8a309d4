"""Table 2 — page-type-aware allocation (§5.4).

FILE pages (caches) allocate slow-first; ANON keeps fast-first.  The
paper's claim: all-local performance with a small fast tier for the
cache-heavy workloads (0.2-2.5% drop) and the placement converges from
a better starting point (fewer migrations).

Counterpart of ``benchmarks/table2_type_aware.py`` over
:mod:`repro_torch.core`: the lines equal the JAX suite's but for the
timing column.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

from repro_torch.benchmarks.common import (
    GEOM, MEASURE_FROM, POLICY_CFG, SEED, SLOW_COST, STEPS,
)
from repro_torch.core import TieredSimulator
from repro_torch.core.trace import make_trace

ROWS = [("web", "2:1"), ("cache1", "1:4"), ("cache2", "1:4")]


def run(quick: bool = False, engine: str = "reference") -> List[str]:
    steps = 100 if quick else STEPS
    measure = 60 if quick else MEASURE_FROM
    out = []
    for wl, geom in ROWS:
        fast, slow, total = GEOM[geom]
        for aware in (False, True):
            cfg = dataclasses.replace(POLICY_CFG, file_to_slow=aware)
            t0 = time.time()
            sim = TieredSimulator(wl, "tpp", fast, slow, config=cfg,
                                  slow_cost=SLOW_COST, seed=SEED,
                                  trace=make_trace(wl, seed=SEED,
                                                   total_pages=total),
                                  engine=engine)
            r = sim.run(steps, measure_from=measure)
            dt_us = (time.time() - t0) * 1e6 / steps
            migrations = r.vmstat.pgdemote_total + r.vmstat.pgpromote_total
            out.append(
                f"table2/{wl}_{geom}_aware={aware},{dt_us:.1f},"
                f"tput={r.throughput_vs_ideal:.4f};local={r.mean_local_fraction:.3f};"
                f"migrations={migrations}"
            )
    return out


if __name__ == "__main__":
    for line in run():
        print(line)
