"""Re-run selected dry-run cells and merge them into a results JSON
(counterpart of ``repro/launch/dryrun_update.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun_update \\
      --cells "phi3-medium-14b:train_4k,chatglm3-6b:train_4k" [--out path]

Each cell runs on both production meshes (``--single-pod-only``: the
(16, 16) one); its rows replace any of the same arch, shape and mesh.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from repro_torch.launch.dryrun import run_cell


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", required=True, help="comma-separated arch:shape pairs")
    ap.add_argument("--out", default="results/dryrun_results.json")
    ap.add_argument("--single-pod-only", action="store_true")
    args = ap.parse_args(argv)

    with open(args.out) as f:
        results = json.load(f)

    for cell in args.cells.split(","):
        arch, shape = cell.split(":")
        meshes = [False] if args.single_pod_only else [False, True]
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            try:
                new = run_cell(arch, shape, multi_pod=mp)
            except Exception as e:  # a failing cell is recorded, as in --all
                new = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "status": "FAILED", "error": f"{type(e).__name__}: {e}"[:500]}
                print(f"FAILED {arch} {shape} {mesh_name}: {e}")
            results = [
                r for r in results
                if not (r["arch"] == arch and r["shape"] == shape
                        and r.get("mesh") == mesh_name)
            ] + [new]

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"merged {args.cells} into {args.out}")


if __name__ == "__main__":
    main()
