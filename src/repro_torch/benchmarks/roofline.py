"""§Roofline — three-term analysis per (arch × shape) from the dry-run.

Counterpart of ``benchmarks/roofline.py`` over the port's dry-run.
Reads the JSON that ``python -m repro_torch.launch.dryrun --all --out
PATH`` writes (the path is an argument) and derives, per single-pod
cell (the 16x16 mesh):

    compute    = flops             / peak FLOP/s (bfloat16)   [s]
    memory     = bytes_accessed    / HBM bandwidth            [s]
    collective = collective_total  / network link bandwidth   [s]

The dry-run's counts are already per device (each rank's local ops), so
no division by device count.  Hardware: one NVIDIA H100 SXM a rank at
its 700 W power limit (``common.py``): 989 TFLOP/s dense bfloat16 (the
dry-run's dtype), 3.35 TB/s HBM3, and one 400 Gb/s NDR NIC (50 GB/s) as
the link a 256/512-rank mesh's collectives cross.

Also reports MODEL_FLOPS (6·N·D train / 2·N·tokens serve, N_active for
MoE) and the useful-compute ratio MODEL_FLOPS / flops.

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline dryrun_results.json
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import torch

from repro_torch.benchmarks.common import HBM_BYTES_PER_S, NET_BYTES_PER_S, PEAK_FLOPS

PEAK_FLOPS_BF16 = PEAK_FLOPS["bfloat16"]


def _leaves_with_names(tree, names=()):
    """``(key names, leaf)`` of every tensor leaf, dict keys and list
    indices as strings (JAX's path names)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_names(v, names + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_names(v, names + (str(i),))
    elif tree is not None:
        yield names, tree


def _param_count(arch: str) -> Dict[str, float]:
    """Total + active param counts, from the param tree built on the
    ``meta`` device (shapes only, nothing allocated)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    cfg = get_config(arch)
    params = init_params(cfg, torch.Generator(), device="meta", dtype=torch.bfloat16)
    total = 0
    # active params for MoE: replace expert banks by top_k/n_experts share
    active = 0.0
    for names, leaf in _leaves_with_names(params):
        total += leaf.numel()
        frac = 1.0
        if "moe" in names and names[-1] in ("wi_gate", "wi_up", "wo"):
            moe = next(s.moe for s in cfg.all_specs() if s.moe is not None)
            frac = moe.top_k / moe.n_experts
        active += leaf.numel() * frac
    return {"total": float(total), "active": float(active)}


def model_flops(arch: str, shape: str, n_dev: int) -> float:
    """Per-device useful model FLOPs for the step kind."""
    from repro_torch.configs import SHAPES

    seq, batch, kind = SHAPES[shape]
    pc = _param_count(arch)
    n = pc["active"]
    if kind == "train":
        return 6.0 * n * (seq * batch) / n_dev
    if kind == "prefill":
        return 2.0 * n * (seq * batch) / n_dev
    return 2.0 * n * batch / n_dev  # decode: one token per sequence


def terms(cell: Dict) -> Dict[str, float]:
    """The three roofline terms of one dry-run cell, in seconds."""
    return {
        "t_compute": cell["flops"] / PEAK_FLOPS_BF16,
        "t_memory": cell["bytes_accessed"] / HBM_BYTES_PER_S,
        "t_collective": cell["collective_total"] / NET_BYTES_PER_S,
    }


def analyze(results_path: str) -> List[Dict]:
    with open(results_path) as f:
        cells = json.load(f)
    rows = []
    seen_skips = set()
    for c in cells:
        if c.get("mesh") != "16x16" or c.get("status") != "ok":
            if (c.get("status") == "skipped"
                    and (c["arch"], c["shape"]) not in seen_skips):
                seen_skips.add((c["arch"], c["shape"]))
                rows.append({"arch": c["arch"], "shape": c["shape"],
                             "status": "skipped"})
            continue
        t = terms(c)
        t_comp, t_mem, t_coll = t["t_compute"], t["t_memory"], t["t_collective"]
        dom = max((t_comp, "compute"), (t_mem, "memory"), (t_coll, "collective"))
        mf = model_flops(c["arch"], c["shape"], c["n_devices"])
        rows.append({
            "arch": c["arch"],
            "shape": c["shape"],
            "status": "ok",
            "t_compute_s": t_comp,
            "t_memory_s": t_mem,
            "t_collective_s": t_coll,
            "bottleneck": dom[1],
            "model_flops": mf,
            "useful_ratio": mf / c["flops"] if c["flops"] > 0 else 0.0,
            # roofline fraction: useful compute time / dominant-term time
            "roofline_frac": (mf / PEAK_FLOPS_BF16) / max(t_comp, t_mem, t_coll),
        })
    return rows


def run(quick: bool = False, dryrun: Optional[str] = None) -> List[str]:
    """One line a cell of the dry-run JSON at ``dryrun``."""
    if dryrun is None or not os.path.exists(dryrun):
        return ["roofline/missing,0.0,run `python -m repro_torch.launch.dryrun "
                "--all --out PATH` and pass PATH"]
    out = []
    for r in analyze(dryrun):
        if r["status"] == "skipped":
            out.append(f"roofline/{r['arch']}/{r['shape']},0.0,skipped")
            continue
        out.append(
            f"roofline/{r['arch']}/{r['shape']},0.0,"
            f"compute={r['t_compute_s']:.2e};memory={r['t_memory_s']:.2e};"
            f"collective={r['t_collective_s']:.2e};bound={r['bottleneck']};"
            f"useful={r['useful_ratio']:.3f};roofline={r['roofline_frac']:.3f}"
        )
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("dryrun", help="the JSON of `repro_torch.launch.dryrun --out`")
    args = ap.parse_args()
    for line in run(dryrun=args.dryrun):
        print(line)
