"""Quickstart — the TPP mechanism in 60 seconds (counterpart of
``examples/quickstart.py``).

Runs the paper's core loop on a synthetic cache workload: a two-tier
page pool under memory pressure, TPP vs. default Linux, and prints the
Table-1-style comparison plus the /proc/vmstat-style counters, a
Chameleon profile and the multi-tenant slowdown controller.  Host only:
the placement engine is NumPy, so it runs the same with or without a
card, and prints the JAX example's numbers exactly.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""

from repro_torch.core import (
    Chameleon,
    PageType,
    TieredSimulator,
    TppConfig,
    make_trace,
    run_policy_comparison,
)
from repro_torch.qos import QosConfig, SlowdownControllerConfig

CFG = TppConfig(demote_budget=512, promote_budget=256, sample_rate=0.1)


def main() -> None:
    print("=" * 64)
    print("TPP quickstart: cache1 workload, fast tier = 20% of memory")
    print("=" * 64)

    results = run_policy_comparison(
        "cache1",
        fast_frames=512,
        slow_frames=2048,
        steps=160,
        total_pages=1950,
        policies=("linux", "numa_balancing", "autotiering", "tpp"),
        config=CFG,
        slow_cost=3.0,
        measure_from=100,
        seed=1,
    )
    print(f"\n{'policy':16s} {'throughput':>10s} {'local traffic':>13s} "
          f"{'migrations':>10s}")
    for name in ("ideal", "linux", "numa_balancing", "autotiering", "tpp"):
        r = results[name]
        migs = r.vmstat.pgdemote_total + r.vmstat.pgpromote_total
        print(f"{name:16s} {r.throughput_vs_ideal:10.3f} "
              f"{r.mean_local_fraction:13.3f} {migs:10d}")

    # --- the observability story (§5.5) --------------------------------
    print("\nTPP vmstat counters (§5.5):")
    vs = results["tpp"].vmstat
    for key in ("pgdemote_anon", "pgdemote_file", "pgpromote_sampled",
                "pgpromote_candidate", "pgpromote_success_anon",
                "pgpromote_success_file", "pgpromote_candidate_demoted",
                "pgalloc_fast", "pgalloc_slow", "pswpout"):
        print(f"  {key:28s} {getattr(vs, key)}")

    # --- Chameleon characterization (§3) --------------------------------
    print("\nChameleon profile of the same workload (sample rate 1/20):")
    prof = Chameleon(sample_rate=1 / 20)
    sim = TieredSimulator("cache1", "tpp", 2048, 2048, config=CFG,
                          profiler=prof, seed=1)
    sim.run(40)
    t = prof.temperature_fractions(2)
    print(f"  idle fraction (2-interval window): {prof.idle_fraction(2):.1%}")
    print(f"  anon hot: {t[PageType.ANON]['hot']:.1%}   "
          f"file hot: {t[PageType.FILE]['hot']:.1%}")
    cdf = prof.reaccess_cdf(8)
    print(f"  re-access CDF @4 intervals: {cdf[3]:.1%}")

    # --- multi-tenant SLO control ----------------------------------------
    # Any TieredSimulator takes qos=: a QosConfig arms the quota/token
    # arbiter, a SlowdownControllerConfig the Equilibria-style feedback
    # loop that re-divides fast-tier shares each interval so *measured*
    # per-tenant slowdowns converge to per-class SLO targets.
    ctrl = SlowdownControllerConfig(
        qos=QosConfig(classes=("latency_critical", "standard", "batch")),
    )
    mix = "web+cache1+data_warehouse"
    sim = TieredSimulator(mix, "tpp", 512, 2400, config=CFG, slow_cost=3.0,
                          seed=1, engine="vectorized", qos=ctrl,
                          trace=make_trace(mix, seed=1, total_pages=1950))
    r = sim.run(160)
    print("\nSlowdown controller (web+cache1+data_warehouse, 160 steps):")
    for (tid, slow), tgt in zip(sorted(r.tenant_slowdowns().items()),
                                r.qos["slo_targets"]):
        name = r.tenant_names[tid]
        print(f"  tenant {tid} ({name:15s}) slowdown x{slow:.2f}"
              f"  → SLO target x{tgt:.2f}")
    print(f"  steered allocations: {r.vmstat.pgalloc_steered}"
          f"   shares: {r.qos['shares']}")


if __name__ == "__main__":
    main()
