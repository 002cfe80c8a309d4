"""§Perf hillclimb driver: hypothesis → change → re-trace → measure.

Counterpart of ``benchmarks/perf_iterations.py`` over the port's
dry-run.  Runs a chosen (arch × shape) cell through
``repro_torch.launch.dryrun.run_cell`` under a sequence of named
configuration variants (the dry-run's ``PERF`` knobs and
``models/attention.py``'s ``DEFAULT_KV_CHUNK``), printing the three
roofline terms per variant (``roofline.terms``: the H100's peaks) as one
JSON line each, and appending them to the log at ``--out`` when given.

  PYTHONPATH=src python -m repro_torch.benchmarks.perf_iterations --arch tinyllama-1.1b \
      --shape train_4k --variants baseline,ce_onehot --out perf_log.json
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict

from repro_torch.benchmarks.roofline import terms
from repro_torch.launch.dryrun import PERF, run_cell
from repro_torch.models import attention


def _reset():
    PERF["ce_onehot"] = False
    PERF["ce_chunk_override"] = None
    PERF["remat_policy"] = None
    PERF["moe_ep"] = False
    attention.DEFAULT_KV_CHUNK = 1024


def v_moe_ep():
    _reset()
    PERF["moe_ep"] = True


def v_moe_ep_onehot():
    _reset()
    PERF["moe_ep"] = True
    PERF["ce_onehot"] = True


def v_remat_dots():
    _reset()
    PERF["remat_policy"] = "dots"


def v_all_train_opts():
    _reset()
    PERF["moe_ep"] = True
    PERF["ce_onehot"] = True
    PERF["remat_policy"] = "dots"


def v_baseline():
    _reset()


def v_ce_onehot():
    _reset()
    PERF["ce_onehot"] = True


def v_ce_chunk_2k():
    _reset()
    PERF["ce_onehot"] = True
    PERF["ce_chunk_override"] = 2048


def v_ce_chunk_128():
    _reset()
    PERF["ce_onehot"] = True
    PERF["ce_chunk_override"] = 128


def v_kv_chunk_2k():
    _reset()
    PERF["ce_onehot"] = True
    attention.DEFAULT_KV_CHUNK = 2048


def v_kv_chunk_512():
    _reset()
    PERF["ce_onehot"] = True
    attention.DEFAULT_KV_CHUNK = 512


VARIANTS: Dict[str, Callable] = {
    "baseline": v_baseline,
    "ce_onehot": v_ce_onehot,
    "ce_chunk_2k": v_ce_chunk_2k,
    "ce_chunk_128": v_ce_chunk_128,
    "kv_chunk_2k": v_kv_chunk_2k,
    "kv_chunk_512": v_kv_chunk_512,
    "moe_ep": v_moe_ep,
    "moe_ep_onehot": v_moe_ep_onehot,
    "remat_dots": v_remat_dots,
    "all_train_opts": v_all_train_opts,
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--out", metavar="PATH", default=None,
                    help="append the entries to the JSON log here")
    args = ap.parse_args()
    names = args.variants.split(",")
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        ap.error(f"unknown variant(s) {unknown}; choose from {','.join(VARIANTS)}")

    log = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            log = json.load(f)

    for name in names:
        VARIANTS[name]()
        t0 = time.time()
        cell = run_cell(args.arch, args.shape, multi_pod=False, verbose=False)
        if cell["status"] != "ok":
            raise SystemExit(f"{args.arch} {args.shape}: {cell}")
        entry = {
            "arch": args.arch,
            "shape": args.shape,
            "variant": name,
            "wall_s": round(time.time() - t0, 1),
            **{k: cell.get(k) for k in ("flops", "bytes_accessed",
                                        "collective_total", "collective_bytes")},
            **terms(cell),
        }
        log.append(entry)
        print(json.dumps(entry))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(log, f, indent=1)


if __name__ == "__main__":
    main()
