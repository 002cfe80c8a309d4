"""Tables 3-4 — TPP × TMO-style proactive reclamation interplay (§6.3.2).

TMO is modeled as a userspace reclaimer that continuously evicts the
coldest slow-tier pages ("(z)swap") at a PSI-throttled rate.  Claims to
reproduce qualitatively:

* TMO **with** TPP saves more memory at less stall: demotion makes
  (z)swap two-stage — victims get a second chance on the slow tier, so
  refaults (process-stall proxy) drop vs TMO-only.
* TPP **with** TMO migrates with fewer failures (more free frames).

Counterpart of ``benchmarks/table3_tmo.py`` over :mod:`repro_torch.core`:
the lines equal the JAX suite's but for the timing column.
"""

from __future__ import annotations

import time
from typing import List

from repro_torch.benchmarks.common import GEOM, MEASURE_FROM, POLICY_CFG, SEED, SLOW_COST, STEPS
from repro_torch.core import TieredSimulator, Tier
from repro_torch.core.trace import make_trace


class TmoReclaimer:
    """Background cold-page eviction with stall-based throttling."""

    def __init__(self, pool, rate=8, stall_threshold=0.02):
        self.pool = pool
        self.rate = rate
        self.stall_threshold = stall_threshold
        self.evicted = 0
        self._refaults_last = 0

    def step(self, refaults_total: int, accesses: int) -> None:
        stall = (refaults_total - self._refaults_last) / max(1, accesses)
        self._refaults_last = refaults_total
        if stall > self.stall_threshold:
            return  # PSI throttle
        victims = self.pool.scan_reclaim_candidates(Tier.SLOW, self.rate)
        for pid in victims:
            self.pool.evict_page(pid)
            self.evicted += 1


def _run(wl: str, policy: str, tmo: bool, steps: int, measure: int,
         engine: str = "reference"):
    fast, slow, total = GEOM["2:1"]
    sim = TieredSimulator(wl, policy, fast, slow, config=POLICY_CFG,
                          slow_cost=SLOW_COST, seed=SEED,
                          trace=make_trace(wl, seed=SEED, total_pages=total),
                          engine=engine)
    reclaimer = TmoReclaimer(sim.pool) if tmo else None
    # interleave: run in windows, let TMO act between them
    refaults = 0
    for w in range(steps // 10):
        r = sim.run(10, measure_from=0 if w * 10 >= measure else 10)
        if reclaimer is not None:
            vs = sim.pool.vmstat
            reclaimer.step(vs.pswpout, max(1, vs.access_fast + vs.access_slow))
    vs = sim.pool.vmstat
    saved = reclaimer.evicted if reclaimer else 0
    return vs, saved


def run(quick: bool = False, engine: str = "reference") -> List[str]:
    steps = 100 if quick else STEPS
    measure = 60 if quick else MEASURE_FROM
    out = []
    for policy, tmo, label in [
        ("tpp", False, "tpp_only"),
        ("tpp", True, "tpp_with_tmo"),
        ("linux", True, "tmo_only"),
    ]:
        t0 = time.time()
        vs, saved = _run("web", policy, tmo, steps, measure, engine=engine)
        dt_us = (time.time() - t0) * 1e6 / steps
        out.append(
            f"table3/{label},{dt_us:.1f},"
            f"mem_saved_pages={saved};refaults={vs.pswpout};"
            f"local={vs.local_access_fraction:.3f};"
            f"migrate_fail={vs.pgdemote_fail_slow_full}"
        )
    return out


if __name__ == "__main__":
    for line in run():
        print(line)
