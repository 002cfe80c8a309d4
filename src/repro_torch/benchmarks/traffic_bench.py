"""Traffic benchmark — per-class SLO goodput under Poisson/bursty load.

Counterpart of ``benchmarks/traffic_bench.py`` over the port's
continuous-batching front end (:mod:`repro_torch.traffic`): a
constrained fast tier, two arrival shapes at equal offered load —
steady Poisson and bursty MMPP — and two relief policies:

* ``shed_only`` — the engine's batch-class admission gate is the only
  pressure valve; running batch lanes keep squatting fast frames while
  new batch work is refused.
* ``victims`` — the scheduler additionally consults the control plane
  (``relief_action``/``order_pressure_victims``): sustained pressure
  evicts the lowest-share × coldest running batch lane (its frames free
  at once, the request restarts later) and pauses colder non-batch
  lanes so TPP demotes their pages.

Reported per class: goodput (SLO-meeting completions per simulated
second) and p50/p99 TTFT/TPOT from the *modeled* latency clock
(:mod:`repro_torch.traffic.latency`), not the device's.  The run
asserts the acceptance bar of the JAX benchmark — victim relief beats
shed-only on latency-critical goodput under both arrival shapes.  With
the smoke config and the JAX weights the lines and the JSON equal the
JAX benchmark's (``tests/test_torch_traffic_reference.py``).  The JSON
is written only to the path ``--out`` names.

  PYTHONPATH=src python -m repro_torch.benchmarks.traffic_bench --smoke --device cpu --quick
  PYTHONPATH=src python -m repro_torch.benchmarks.traffic_bench --out traffic.json
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import torch

from repro_torch.core import TppConfig
from repro_torch.qos import QosConfig
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.traffic import (
    BurstyArrivals,
    PoissonArrivals,
    TrafficConfig,
    TrafficScheduler,
    generate_trace,
)

MODEL = "tinyllama-1.1b"
CLASSES = ("latency_critical", "standard", "batch")
SEED = 7
N_REQUESTS = 56
# equal offered load (requests/sim-second): Poisson at RATE, MMPP
# alternating a 3*RATE burst state with an idle state of equal dwell
RATE = 100.0
RELIEF_MODES = {"shed_only": "shed", "victims": "control"}
KINDS = ("poisson", "bursty")
# a *constrained* fast tier: four decode lanes' working sets cannot all
# fit the 16 fast frames, so sustained traffic holds the pool at the
# reclaim watermarks
ENGINE_CONFIG = EngineConfig(
    page_size=4, num_fast=16, num_slow=256,
    topk_pages=4, recent_pages=2, max_seqs=4,
    data_plane="batched",
    tpp=TppConfig(demote_budget=16, promote_budget=8),
    qos=QosConfig(classes=CLASSES, evict_after=2),
)


def arrivals(kind: str):
    if kind == "poisson":
        return PoissonArrivals(RATE)
    return BurstyArrivals(3.0 * RATE, idle_rate=RATE / 3.0,
                          mean_burst=0.1, mean_idle=0.2)


def trace(kind: str, vocab: int, n_requests: int = N_REQUESTS):
    return generate_trace(arrivals(kind), seed=SEED, vocab=vocab,
                          max_requests=n_requests)


def scheduler(cfg, params, trace_, relief: str, ecfg: EngineConfig = ENGINE_CONFIG,
              device="cuda") -> TrafficScheduler:
    """The benchmark's engine and scheduler over ``trace_``: short pauses
    and a ~10-step post-evict hold, long enough for the latency-critical
    lanes to regain fast residency, short enough that batch restarts
    don't stretch the run's tail."""
    eng = ServingEngine(cfg, params, ecfg, seed=0, device=device)
    return TrafficScheduler(eng, trace_, TrafficConfig(
        relief=relief, pause_steps=4, evict_backoff_steps=10))


def _run(cfg, params, kind: str, relief: str, n_requests: int, device) -> Dict:
    sched = scheduler(cfg, params, trace(kind, cfg.vocab, n_requests), relief,
                      device=device)
    res = sched.run()
    summary = res.summary()
    summary["lc_goodput_rps"] = round(res.lc_goodput, 4)
    return summary


def run(quick: bool = False, arch: str = MODEL, smoke: bool = False,
        device="cuda", out: Optional[str] = None) -> List[str]:
    """The four runs (two arrival shapes × two relief modes) of ``arch``
    (its smoke config with ``smoke``) on weights seeded 0 on ``device``.
    Writes the JSON to ``out`` when given."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.model import init_params

    n_requests = 24 if quick else N_REQUESTS
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)

    lines: List[str] = []
    results: Dict[str, Dict] = {}
    for kind in KINDS:
        results[kind] = {}
        for label, relief in RELIEF_MODES.items():
            s = _run(cfg, params, kind, relief, n_requests, device)
            results[kind][label] = s
            lc = s["per_class"].get("latency_critical", {})
            lines.append(
                f"traffic/{kind}_{label},0.0,"
                f"lc_goodput={s['lc_goodput_rps']:.2f},"
                f"lc_ttft_p99={lc.get('ttft_p99_ms')},"
                f"lc_tpot_p99={lc.get('tpot_p99_ms')},"
                f"evictions={s['evictions']},sheds={s['sheds']}"
            )
        shed_lc = results[kind]["shed_only"]["lc_goodput_rps"]
        vict_lc = results[kind]["victims"]["lc_goodput_rps"]
        # the acceptance bar: victim relief must beat shed-only
        # admission on latency-critical goodput
        assert vict_lc > shed_lc, (
            f"{kind}: victim relief ({vict_lc} rps) does not beat "
            f"shed-only ({shed_lc} rps) on latency-critical goodput"
        )
        gain = vict_lc / shed_lc if shed_lc > 0 else float("inf")
        results[kind]["lc_goodput_gain"] = (
            round(gain, 3) if gain != float("inf") else "inf")
        lines.append(f"traffic/{kind}_lc_gain,0.0,x{gain:.2f}")

    if out is not None:
        payload = {
            "model": cfg.name,
            "requests": n_requests,
            "seed": SEED,
            "offered_rate_rps": RATE,
            "bursty_mean_rate_rps": round(arrivals("bursty").mean_rate, 2),
            "results": results,
        }
        with open(out, "w") as f:
            json.dump(payload, f, indent=2)
    return lines


if __name__ == "__main__":
    import argparse

    from repro_torch.configs import served_archs

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="24 requests, not 56")
    ap.add_argument("--arch", default=MODEL, choices=served_archs())
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", metavar="PATH", help="write the JSON results here")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda":
        from repro_torch.launch.serve import strict_fp32

        strict_fp32()
    for line in run(quick=args.quick, arch=args.arch, smoke=args.smoke,
                    device=args.device, out=args.out):
        print(line)
