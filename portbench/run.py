"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (kernels built into the checkout's
``build/`` or loaded from there, seeded weights made on the card, the
cell's warm-up) is timed as ``setup_s``; then the cell's loop runs for
``--seconds`` and, with ``--trace 1``, a slice of it is traced for the
per-layer metrics.  Once the window has closed the engine is freed and
the plain reference judges a sample of the finished requests.  The last
line of standard output is the result as one JSON object; the numbers
compared and their limits are the last lines of standard error.

Exits non-zero without a CUDA card (or with fewer than the cell asks
for), and if ``jax``, ``jaxlib``, ``flax`` or ``repro`` is loaded once
the window has closed.  ``--list`` prints each cell with the files it reads and its per-layer metrics.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / "build" / "portbench-cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def loaded_forbidden() -> list:
    """Top-level module names (compared whole) that the run may not hold."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()

    cache_dirs()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench.harness import spec

    if args.list:
        for w in spec.load_benchmark(ROOT)["workloads"]:
            cell = spec.load_cell(w["name"], ROOT)
            for m in cell.per_layer:
                spec.metric_reader(m["name"], ROOT)
            print(w["name"], cell.config["name"], " ".join(m["name"] for m in cell.per_layer))
        return 0
    if args.workload is None or args.seed is None or args.seconds is None:
        ap.error("--workload, --seed and --seconds are required")
    cell = spec.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench.harness.cell import run_cell

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START, time.perf_counter)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
