"""Readings that set a cell's output-check limits, several seeds in one
process (set-up is long; the benchmark's own runs never run this).

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 30 --dtype bfloat16

``--dtype float32`` reads the sound runs (the lower readings);
``--dtype bfloat16`` serves the same weights in bfloat16 through the
program's own bfloat16 path, the nearest precision below the float32 the
configurations state: the control, whose readings must fail the limit
(the upper readings).  The reference stays float32.  One JSON line a
seed: the numbers compared, the tokens set aside at ties and where the
widest gaps lie.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA card", file=sys.stderr)
        return 2
    from portbench.harness import spec
    from portbench.harness.cell import run_cell

    cell = spec.load_cell(args.workload, ROOT)
    t = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(cell, seed, args.seconds, False, "cuda", t, time.perf_counter,
                       dtype=getattr(torch, args.dtype))
        print(json.dumps({"seed": seed, "dtype": args.dtype, "correct": out["correct"],
                          "check": out["check"], "diagnostics": out["diagnostics"],
                          "metrics": out["metrics"]}), flush=True)
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
