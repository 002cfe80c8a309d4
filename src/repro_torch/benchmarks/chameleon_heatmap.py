"""Figs 7-9 + 11 — Chameleon characterization of the workload traces.

Per workload: idle fraction over 2-interval windows (paper: 55-80%),
hot/warm/cold fractions per page type (anon vs file, Fig. 8), residency
mix over time (Fig. 9), and the re-access-interval CDF (Fig. 11).

Counterpart of ``benchmarks/chameleon_heatmap.py`` over
:mod:`repro_torch.core`: the lines equal the JAX suite's but for the
timing column.
"""

from __future__ import annotations

import time
from typing import List

from repro_torch.benchmarks.common import POLICY_CFG, SEED
from repro_torch.core import Chameleon, PageType, TieredSimulator


WORKLOADS = ["web", "cache1", "cache2", "data_warehouse", "ads"]


def run(quick: bool = False) -> List[str]:
    steps = 24 if quick else 48
    out = []
    for wl in WORKLOADS:
        prof = Chameleon(sample_rate=1.0, seed=SEED)
        t0 = time.time()
        sim = TieredSimulator(wl, "tpp", 4096, 4096, config=POLICY_CFG,
                              seed=SEED, profiler=prof)
        sim.run(steps)
        dt_us = (time.time() - t0) * 1e6 / steps
        idle = prof.idle_fraction(2)
        temps = prof.temperature_fractions(2)
        cdf = prof.reaccess_cdf(16)
        usage = prof.usage_over_time()
        anon_res = usage[-1].resident.get(PageType.ANON, 0)
        file_res = usage[-1].resident.get(PageType.FILE, 0)
        out.append(
            f"chameleon/{wl},{dt_us:.1f},"
            f"idle2={idle:.3f};anon_hot={temps[PageType.ANON]['hot']:.3f};"
            f"file_hot={temps[PageType.FILE]['hot']:.3f};"
            f"reaccess_cdf4={cdf[3]:.3f};reaccess_cdf10={cdf[9]:.3f};"
            f"resident_anon={anon_res};resident_file={file_res}"
        )
        # sampling-rate overhead/accuracy knob (paper §3: 1/200 default)
        if wl == "web" and not quick:
            for rate in (1.0, 1 / 20, 1 / 200):
                p2 = Chameleon(sample_rate=rate, seed=SEED)
                sim2 = TieredSimulator(wl, "tpp", 4096, 4096,
                                       config=POLICY_CFG, seed=SEED,
                                       profiler=p2)
                sim2.run(24)
                out.append(
                    f"chameleon/sampling_{rate:.4f},0.0,"
                    f"samples={p2.total_samples};idle2={p2.idle_fraction(2):.3f}"
                )
    return out


if __name__ == "__main__":
    for line in run():
        print(line)
