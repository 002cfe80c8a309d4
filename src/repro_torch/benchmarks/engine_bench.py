"""Engine speed benchmark — reference vs vectorized placement engine.

Replays one pre-generated fleet-scale multi-tenant trace (100k pages,
four co-running workloads) through both engines under the same policy
and reports pages/sec (touched pages per wall-second of simulation,
trace generation excluded).  Parity of the vmstat trajectories is
asserted on every run — a speedup that changes results is a bug, not a
win.

The run also measures the TierSan ``conservation`` sanitizer's overhead
on the vectorized fast path (``tiersan_overhead_pct``): the conservation
laws are meant to stay on in long runs, so the acceptance bar is <5%.

Counterpart of ``benchmarks/engine_bench.py`` over
:mod:`repro_torch.core`: the same lines (the counts equal, the times
this machine's).  The JSON is written only to the path ``--out`` names,
never to ``BENCH_engine.json``.

  PYTHONPATH=src python -m repro_torch.benchmarks.engine_bench --quick --out engine.json
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional

from repro_torch.benchmarks.common import SEED
from repro_torch.analysis.tiersan import TierSan
from repro_torch.core import TieredSimulator, TppConfig, record_trace
from repro_torch.core.trace import WORKLOADS, MultiTenantTrace

MIX = "web+cache1+ads+cache2"
TOTAL_PAGES = 100_000
FAST_FRAMES = 50_000
SLOW_FRAMES = 80_000
ACCESSES_PER_STEP = 16_384  # per tenant
CFG = TppConfig(demote_budget=512, promote_budget=256, sample_rate=0.1)


def _recorded_trace(steps: int, total_pages: int):
    names = MIX.split("+")
    specs = [
        dataclasses.replace(WORKLOADS[n], accesses_per_step=ACCESSES_PER_STEP)
        for n in names
    ]
    src = MultiTenantTrace(specs, seed=SEED,
                           total_pages_each=total_pages // len(names))
    return record_trace(src, steps)


def run(quick: bool = False, engine: str = "reference",
        out: Optional[str] = None) -> List[str]:
    """Both engines under each policy; writes the JSON to ``out`` when
    given."""
    del engine  # this benchmark always measures both engines
    steps = 8 if quick else 20
    total_pages = 20_000 if quick else TOTAL_PAGES
    fast = FAST_FRAMES * total_pages // TOTAL_PAGES
    slow = SLOW_FRAMES * total_pages // TOTAL_PAGES
    recorded = _recorded_trace(steps, total_pages)

    lines: List[str] = []
    results = {}
    for policy in ("tpp", "linux"):
        row = {}
        vm = {}
        for eng in ("reference", "vectorized"):
            # CPU time + best-of-two for the fast engine: scheduler noise
            # can only inflate a CPU-time measurement, so min is honest.
            n_runs = 2 if eng == "vectorized" else 1
            dt = float("inf")
            for _ in range(n_runs):
                sim = TieredSimulator(MIX, policy, fast, slow, config=CFG,
                                      seed=SEED, trace=recorded.reset(),
                                      engine=eng)
                t0 = time.process_time()
                r = sim.run(steps)
                dt = min(dt, time.process_time() - t0)
            pages = r.vmstat.access_fast + r.vmstat.access_slow
            row[eng] = {
                "seconds": round(dt, 3),
                "pages": pages,
                "pages_per_sec": round(pages / dt, 1),
            }
            vm[eng] = r.vmstat.as_dict()
            lines.append(
                f"engine/{policy}_{eng},{dt * 1e6 / steps:.1f},"
                f"pages_per_sec={pages / dt:.0f}"
            )
        assert vm["reference"] == vm["vectorized"], (
            f"engine parity broken for policy {policy}"
        )
        speedup = (row["vectorized"]["pages_per_sec"]
                   / row["reference"]["pages_per_sec"])
        row["speedup"] = round(speedup, 2)
        results[policy] = row
        lines.append(f"engine/{policy}_speedup,0.0,x{speedup:.1f}")

    # TierSan conservation overhead on the vectorized fast path: the
    # same tpp replay with and without the sanitizer attached (every
    # interval).  Pairs run interleaved with best-of-3 per arm so both
    # see the same cache warmth — a non-interleaved baseline drowns the
    # sub-ms checks in scheduler noise.
    times = {"off": float("inf"), "conservation": float("inf")}
    checks = 0
    for _ in range(3):
        for level in ("off", "conservation"):
            sim = TieredSimulator(MIX, "tpp", fast, slow, config=CFG,
                                  seed=SEED, trace=recorded.reset(),
                                  engine="vectorized")
            if level != "off":
                sim.pool.tiersan = TierSan(level)
            t0 = time.process_time()
            sim.run(steps)
            times[level] = min(times[level], time.process_time() - t0)
            if sim.pool.tiersan is not None:
                checks = sim.pool.tiersan.checks
    assert checks > 0, "sanitizer did not run"
    overhead_pct = max(
        0.0, (times["conservation"] - times["off"]) / times["off"] * 100.0
    )
    tiersan_row = {
        "level": "conservation",
        "checks": checks,
        "seconds": round(times["conservation"], 3),
        "baseline_seconds": round(times["off"], 3),
        "overhead_pct": round(overhead_pct, 2),
    }
    lines.append(
        f"engine/tiersan_conservation,{times['conservation'] * 1e6 / steps:.1f},"
        f"overhead_pct={overhead_pct:.2f}"
    )

    payload = {
        "mix": MIX,
        "total_pages": total_pages,
        "steps": steps,
        "accesses_per_step_per_tenant": ACCESSES_PER_STEP,
        "fast_frames": fast,
        "slow_frames": slow,
        "results": results,
        "tiersan": tiersan_row,
    }
    if out is not None:
        with open(out, "w") as f:
            json.dump(payload, f, indent=2)
    return lines


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="20k pages, 8 steps")
    ap.add_argument("--out", metavar="PATH", help="write the JSON results here")
    args = ap.parse_args()
    for line in run(quick=args.quick, out=args.out):
        print(line)
