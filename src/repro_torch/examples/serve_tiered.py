"""Tiered serving demo: batched requests over the TPP-managed KV cache
(counterpart of ``examples/serve_tiered.py``).

Three sessions decode concurrently against a fast tier sized well below
the total KV footprint; one session pauses mid-stream (its pages cool
off and demote) and later resumes (hint faults promote them back).
Prints per-phase placement stats: the serving-side Fig. 14 analogue.

The **batched** data plane (the default) decodes all sessions a step in
one call through the ``paged_attention`` kernel and moves migrations as
staged ``page_gather``/``page_scatter`` batches; ``--data-plane
reference`` runs the per-sequence executable spec.  ``--traffic
poisson|bursty`` switches to the continuous-batching front end
(:mod:`repro_torch.traffic`): an arrival trace drives prefill, insert
and generate slot scheduling over a constrained fast tier, with the QoS
control plane picking pause/evict victims under pressure, and prints
per-class TTFT/TPOT and goodput.  ``--short`` shrinks the prompts and
phases.  Weights are the port's ``init_params``, drawn from a seeded
CPU generator and moved to ``--device`` (``cuda`` unless asked for
``cpu``), so the card and the CPU serve the same model.

  PYTHONPATH=src python -m repro_torch.examples.serve_tiered [--short]
      [--data-plane reference] [--traffic poisson|bursty] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import Tier, TppConfig
from repro_torch.models.model import init_params
from repro_torch.serving import EngineConfig, ServingEngine


def seeded_params(cfg, device, seed: int = 0):
    """The demo's weights: drawn on the CPU from ``seed``, then moved."""
    return init_params(cfg, torch.Generator().manual_seed(seed), device=device)


def phase_stats(eng: ServingEngine, label: str) -> Dict[str, Any]:
    s = eng.stats()
    print(f"  [{label:12s}] local={s['local_fraction']:.3f} "
          f"demoted={s['demoted']:4d} promoted={s['promoted']:4d} "
          f"migrated={s['migrated_bytes']/1e6:.1f}MB "
          f"fast_free={s['fast_free']}")
    return s


def traffic_demo(args, params: Optional[Any] = None,
                 run: Optional[Callable] = None) -> Dict[str, Any]:
    """Continuous batching under live traffic + control-plane relief →
    the run's ``summary`` (``TrafficResult.summary()``) and its
    ``engine``; ``run(sched)`` drives the scheduler (default
    ``sched.run()``)."""
    from repro_torch.qos import QosConfig
    from repro_torch.traffic import (
        BurstyArrivals, PoissonArrivals, TrafficConfig, TrafficScheduler,
        generate_trace,
    )

    n_requests = 16 if args.short else 40
    cfg = get_smoke_config("tinyllama-1.1b")
    params = params if params is not None else seeded_params(cfg, args.device)
    eng = ServingEngine(cfg, params, EngineConfig(
        page_size=4, num_fast=16, num_slow=256,
        topk_pages=4, recent_pages=2, max_seqs=4,
        data_plane=args.data_plane,
        tpp=TppConfig(demote_budget=16, promote_budget=8),
        qos=QosConfig(
            classes=("latency_critical", "standard", "batch"),
            evict_after=2,
        ),
    ), device=args.device)
    process = (PoissonArrivals(100.0) if args.traffic == "poisson"
               else BurstyArrivals(300.0, idle_rate=33.0,
                                   mean_burst=0.1, mean_idle=0.2))
    trace = generate_trace(process, seed=7, vocab=cfg.vocab,
                           max_requests=n_requests)
    sched = TrafficScheduler(eng, trace, TrafficConfig(
        relief="control", pause_steps=4, evict_backoff_steps=10))
    print(f"{n_requests} requests, {args.traffic} arrivals, 4 decode "
          f"lanes over a 16-frame fast tier; relief: control "
          f"(shed -> pause/evict victims)")
    res = run(sched) if run is not None else sched.run()
    print(f"\n{res.steps} decode steps over {res.horizon_ms / 1e3:.2f} "
          f"simulated seconds; evictions={res.evictions} "
          f"pauses={res.pauses} sheds={res.sheds} drops={res.drops}\n")
    for cls, m in sorted(res.per_class.items()):
        if not m.arrived:
            continue
        s = m.summary(res.horizon_ms)
        print(f"  [{cls:16s}] arrived={s['arrived']:3d} "
              f"completed={s['completed']:3d} slo_met={s['slo_met']:3d} "
              f"goodput={s['goodput_rps']:.1f}/s "
              f"ttft_p99={s['ttft_p99_ms']}ms tpot_p99={s['tpot_p99_ms']}ms")
    eng.kv.pool.check_invariants()
    print("\npool invariants hold after the full trace drained ✓")
    return {"summary": res.summary(), "engine": eng}


def pause_resume_demo(args, params: Optional[Any] = None) -> Dict[str, Any]:
    """The pause/resume phases on gemma3-4b's smoke config → per-phase
    stats, the paused session's slow pages, the first tokens, the
    migrations and the ``engine``."""
    prompt_len, max_new = (24, 48) if args.short else (48, 96)
    warm, paused, resumed = (6, 10, 8) if args.short else (12, 20, 16)
    cfg = get_smoke_config("gemma3-4b")  # 5:1 local:global pattern
    params = params if params is not None else seeded_params(cfg, args.device)
    eng = ServingEngine(
        cfg, params,
        EngineConfig(
            page_size=4, num_fast=24, num_slow=128,
            topk_pages=2, recent_pages=2, policy="tpp",
            data_plane=args.data_plane,
            tpp=TppConfig(demote_budget=16, promote_budget=8),
        ),
        device=args.device,
    )
    rng = np.random.default_rng(0)
    rids = [
        eng.add_request(list(rng.integers(0, cfg.vocab, prompt_len)),
                        max_new=max_new)
        for _ in range(3)
    ]
    print(f"3 sessions × {prompt_len}-token prompts; fast tier: 24 pages × "
          f"{eng.ecfg.page_size} tokens (total KV ≫ fast tier); "
          f"data plane: {args.data_plane}")
    report: Dict[str, Any] = {"phases": {}, "engine": eng}

    for _ in range(warm):
        eng.step()
    report["phases"]["warm-up"] = phase_stats(eng, "warm-up")

    eng.pause(rids[0])
    for _ in range(paused):
        eng.step()
    report["phases"]["s0 paused"] = phase_stats(eng, "s0 paused")
    paused_slow = sum(
        1 for pid in eng.seqs[rids[0]].pages
        if eng.kv.pool.pages[pid].tier == Tier.SLOW
    )
    report["paused_slow"] = (paused_slow, len(eng.seqs[rids[0]].pages))
    print(f"    paused session: {paused_slow}/{len(eng.seqs[rids[0]].pages)} "
          f"pages demoted to the slow tier")

    eng.resume(rids[0])
    for _ in range(resumed):
        eng.step()
    report["phases"]["s0 resumed"] = phase_stats(eng, "s0 resumed")

    print("\ngenerated (first 12 tokens each):")
    report["tokens"] = {}
    for rid in rids:
        report["tokens"][rid] = list(eng.requests[rid].out[:12])
        print(f"  req{rid}: {eng.requests[rid].out[:12]}")
    eng.kv.pool.check_invariants()
    vs = eng.kv.pool.vmstat
    report["migrations"] = vs.pgdemote_total + vs.pgpromote_total
    print(f"\npool invariants hold after {report['migrations']} migrations ✓")
    return report


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-plane", default="batched",
                    choices=["reference", "batched"])
    ap.add_argument("--short", action="store_true",
                    help="small prompts / short phases (the smoke lane)")
    ap.add_argument("--traffic", default=None,
                    choices=["poisson", "bursty"],
                    help="continuous-batching front-end demo under this "
                         "arrival process")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    if args.traffic:
        return traffic_demo(args)
    return pause_resume_demo(args)


if __name__ == "__main__":
    main()
