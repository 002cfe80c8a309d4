"""Figs 14-18 analogues: traffic convergence, latency sweep, and the two
mechanism ablations (decoupling, active-LRU hysteresis).

Counterpart of ``benchmarks/fig_ablation.py`` over :mod:`repro_torch.core`:
the lines equal the JAX suite's but for the timing column.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from repro_torch.benchmarks.common import (
    GEOM, MEASURE_FROM, POLICY_CFG, SEED, SLOW_COST, STEPS,
)
from repro_torch.core import TieredSimulator, TppConfig
from repro_torch.core.trace import make_trace


def _sim(workload, policy, cfg, geom="1:4", seed=SEED, slow_cost=SLOW_COST,
         steps=STEPS, measure=MEASURE_FROM, engine="reference"):
    fast, slow, total = GEOM[geom]
    sim = TieredSimulator(workload, policy, fast, slow, config=cfg,
                          slow_cost=slow_cost, seed=seed,
                          trace=make_trace(workload, seed=seed,
                                           total_pages=total),
                          engine=engine)
    return sim.run(steps, measure_from=measure)


def run(quick: bool = False, engine: str = "reference") -> List[str]:
    steps = 100 if quick else STEPS
    measure = 60 if quick else MEASURE_FROM
    out = []

    # ---- Fig 14/15: local-traffic convergence over time -------------- #
    t0 = time.time()
    r = _sim("cache1", "tpp", POLICY_CFG, steps=steps, measure=measure,
             engine=engine)
    dt_us = (time.time() - t0) * 1e6 / steps
    lf = np.array(r.local_fraction)
    q = max(1, len(lf) // 4)
    windows = ";".join(f"w{i}={lf[i*q:(i+1)*q].mean():.3f}" for i in range(4))
    out.append(f"fig14/cache1_local_traffic,{dt_us:.1f},{windows}")

    # ---- Fig 16: varied slow-tier latency ----------------------------- #
    for c in (1.5, 2.0, 3.0):
        r_tpp = _sim("cache2", "tpp", POLICY_CFG, geom="2:1",
                     slow_cost=c, steps=steps, measure=measure, engine=engine)
        r_lin = _sim("cache2", "linux", POLICY_CFG, geom="2:1",
                     slow_cost=c, steps=steps, measure=measure, engine=engine)
        out.append(
            f"fig16/slow_cost_{c},0.0,"
            f"tpp={r_tpp.throughput_vs_ideal:.4f};"
            f"linux={r_lin.throughput_vs_ideal:.4f};"
            f"loss_ratio={(1-r_lin.throughput_vs_ideal)/max(1e-9,1-r_tpp.throughput_vs_ideal):.2f}"
        )

    # ---- Fig 17: decoupled allocation/reclamation --------------------- #
    for dec in (True, False):
        cfg = TppConfig(demote_budget=512, promote_budget=256, sample_rate=0.1, decoupled=dec)
        r = _sim("web", "tpp", cfg, steps=steps, measure=measure,
                 engine=engine)
        alloc_fast = np.array(r.alloc_fast_rate)
        p95 = float(np.percentile(alloc_fast, 95)) if len(alloc_fast) else 0.0
        out.append(
            f"fig17/decoupled_{dec},0.0,"
            f"tput={r.throughput_vs_ideal:.4f};promoted={r.vmstat.pgpromote_total};"
            f"alloc_fast_p95={p95:.1f};stalls={r.vmstat.pgalloc_stall}"
        )

    # ---- Fig 18: active-LRU hysteresis -------------------------------- #
    base = {}
    for filt in (True, False):
        cfg = TppConfig(demote_budget=512, promote_budget=256,
                        sample_rate=0.1, active_lru_filter=filt)
        r = _sim("cache1", "tpp", cfg, steps=steps, measure=measure,
                 engine=engine)
        base[filt] = r
        out.append(
            f"fig18/active_lru_{filt},0.0,"
            f"tput={r.throughput_vs_ideal:.4f};promoted={r.vmstat.pgpromote_total};"
            f"pingpong={r.vmstat.ping_pong_rate:.3f};"
            f"promote_success={r.vmstat.promote_success_rate:.3f}"
        )
    red = base[False].vmstat.pgpromote_total / max(1, base[True].vmstat.pgpromote_total)
    out.append(f"fig18/promotion_traffic_reduction,0.0,x{red:.1f}_less_with_filter")
    return out


if __name__ == "__main__":
    for line in run():
        print(line)
