"""Benchmark driver — one module per paper table/figure.

Counterpart of ``benchmarks/run.py`` over the port's suites.  Prints
``name,us_per_call,derived`` CSV rows (one per measurement).

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--quick] [--only table1,...]
      [--skip-slow] [--engine reference|vectorized] [--device cuda|cpu]
      [--smoke] [--out DIR] [--dryrun PATH]

``--only`` runs a comma-separated subset of suites; ``--skip-slow``
drops the long-running ones (the fast lane CI and developers iterate
on).  ``--engine`` selects the placement engine for the
simulator-backed benchmarks (results are identical by construction —
see ``tests/test_engine_parity.py``; the vectorized engine is the fast
one).  ``--device`` (default ``cuda``) is where the device-backed
suites run: on ``cpu`` they run the kernels' plain versions.
``--smoke`` gives the model-backed suites their smoke config.  A suite
that writes JSON writes it only under ``--out``, as
``DIR/<module>.json``; ``--dryrun`` names the JSON of
``python -m repro_torch.launch.dryrun --out`` that ``roofline`` reads.
A suite that fails prints a ``<key>/ERROR`` row and the driver exits
non-zero after the sweep.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import os
import sys
import time
from typing import Optional, Sequence

from repro_torch.core.engine import ENGINES

# (key, module, slow, entrypoint) — slow suites are multi-minute
# end-to-end sweeps; the rest finish in seconds and form the
# --skip-slow fast lane.  ``entrypoint`` names the module function to
# call (several suites can live in one module).
MODULES = [
    ("table1", "repro_torch.benchmarks.table1_throughput", True, "run"),
    ("chameleon", "repro_torch.benchmarks.chameleon_heatmap", False, "run"),
    ("ablations", "repro_torch.benchmarks.fig_ablation", True, "run"),
    ("table2", "repro_torch.benchmarks.table2_type_aware", False, "run"),
    ("table3", "repro_torch.benchmarks.table3_tmo", True, "run"),
    ("expert_tier", "repro_torch.benchmarks.expert_tiering", True, "run"),
    ("engine", "repro_torch.benchmarks.engine_bench", True, "run"),
    ("qos", "repro_torch.benchmarks.qos_bench", False, "run"),
    ("qos_controller", "repro_torch.benchmarks.qos_bench", False, "run_controller"),
    ("fleet", "repro_torch.benchmarks.fleet_bench", False, "run"),
    ("serving", "repro_torch.benchmarks.serving_bench", True, "run"),
    ("traffic", "repro_torch.benchmarks.traffic_bench", True, "run"),
    ("kernels", "repro_torch.benchmarks.kernel_bench", False, "run"),
    ("roofline", "repro_torch.benchmarks.roofline", True, "run"),
]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of: "
                         + ",".join(k for k, _, _, _ in MODULES))
    ap.add_argument("--skip-slow", action="store_true",
                    help="skip the multi-minute suites ("
                         + ",".join(k for k, _, s, _ in MODULES if s) + ")")
    ap.add_argument("--engine", default="reference", choices=list(ENGINES),
                    help="placement engine for simulator-backed benchmarks")
    ap.add_argument("--device", default="cuda",
                    help="device of the device-backed suites")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke configs for the model-backed suites")
    ap.add_argument("--out", metavar="DIR", default=None,
                    help="write each suite's JSON here as <module>.json")
    ap.add_argument("--dryrun", metavar="PATH", default=None,
                    help="the dry-run's JSON results, for roofline")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    if only:
        unknown = only - {k for k, _, _, _ in MODULES}
        if unknown:
            ap.error(f"unknown suite(s) {sorted(unknown)}; choose from "
                     + ",".join(k for k, _, _, _ in MODULES))
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    print("name,us_per_call,derived")
    t0 = time.time()
    failed: list = []
    for key, modname, slow, entrypoint in MODULES:
        if only and key not in only:
            continue
        if args.skip_slow and slow and not only:
            continue  # an explicit --only overrides --skip-slow
        try:
            mod = importlib.import_module(modname)
            fn = getattr(mod, entrypoint)
            params = inspect.signature(fn).parameters
            kwargs = {"quick": args.quick}
            for name in ("engine", "device", "smoke", "dryrun"):
                if name in params:
                    kwargs[name] = getattr(args, name)
            if "out" in params and args.out:
                kwargs["out"] = os.path.join(args.out,
                                             modname.rsplit(".", 1)[-1] + ".json")
            for line in fn(**kwargs):
                print(line, flush=True)
        except Exception as e:  # keep the suite going; a failure is visible
            print(f"{key}/ERROR,0.0,{type(e).__name__}:{e}", flush=True)
            failed.append(key)
    print(f"# total {time.time()-t0:.1f}s", file=sys.stderr)
    if failed:  # after the full sweep, so one bad suite never hides others
        sys.exit(f"benchmark suite(s) failed: {','.join(failed)}")


if __name__ == "__main__":
    main()
