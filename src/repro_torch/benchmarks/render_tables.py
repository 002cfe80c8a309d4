"""Render markdown tables from results artifacts.

Counterpart of ``benchmarks/render_tables.py``; the dry-run's JSON (of
``python -m repro_torch.launch.dryrun --out``) and the benchmark output
are path arguments.  The port's dry-run traces where JAX's compiles, so
the dry-run table gives each mesh's trace seconds (``trace_s``); XLA's
temp buffer size has no counterpart there and prints "—".

  PYTHONPATH=src python -m repro_torch.benchmarks.render_tables dryrun dryrun_results.json
  PYTHONPATH=src python -m repro_torch.benchmarks.render_tables roofline dryrun_results.json
  PYTHONPATH=src python -m repro_torch.benchmarks.render_tables bench bench_output.txt
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict


def _fmt_bytes(n):
    if n is None:
        return "—"
    if n >= 1e9:
        return f"{n/1e9:.2f}G"
    if n >= 1e6:
        return f"{n/1e6:.1f}M"
    return f"{n/1e3:.0f}K"


def dryrun_table(path: str) -> str:
    with open(path) as f:
        cells = json.load(f)
    by = defaultdict(dict)
    skips = set()
    for c in cells:
        if c.get("status") == "skipped":
            skips.add((c["arch"], c["shape"]))
            continue
        by[(c["arch"], c["shape"])][c.get("mesh", "-")] = c
    for key in skips:
        by.setdefault(key, {"skip": True})
    lines = [
        "| arch | shape | 16×16 (trace s) | 2×16×16 (trace s) | args/dev | act-peak est | XLA temp | collective/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), meshes in sorted(by.items()):
        if meshes.get("skip"):
            lines.append(f"| {arch} | {shape} | skip | skip | — | — | — | — |")
            continue
        sp = meshes.get("16x16", {})
        mp = meshes.get("2x16x16", {})
        s1 = "✓" if sp.get("status") == "ok" else "✗"
        s2 = "✓" if mp.get("status") == "ok" else ("—" if not mp else "✗")
        lines.append(
            f"| {arch} | {shape} | {s1} ({sp.get('trace_s', '-')}s) | {s2} "
            f"({mp.get('trace_s', '-')}s) | "
            f"{_fmt_bytes(sp.get('argument_size_in_bytes', 0))} | "
            f"{_fmt_bytes(sp.get('act_peak_est', 0))} | "
            f"{_fmt_bytes(sp.get('temp_size_in_bytes'))} | "
            f"{_fmt_bytes(sp.get('collective_total', 0))} |"
        )
    return "\n".join(lines)


def roofline_table(path: str) -> str:
    from repro_torch.benchmarks.roofline import analyze

    rows = analyze(path)
    lines = [
        "| arch | shape | compute [s] | memory [s] | collective [s] | bound | useful | roofline |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"])):
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | skip | — | — |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.2e} | "
            f"{r['t_memory_s']:.2e} | {r['t_collective_s']:.2e} | "
            f"{r['bottleneck']} | {r['useful_ratio']:.2f} | {r['roofline_frac']:.3f} |"
        )
    return "\n".join(lines)


def bench_table(path: str) -> str:
    lines = ["| benchmark | derived |", "|---|---|"]
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("name,", "#")):
                continue
            parts = line.split(",", 2)
            if len(parts) == 3:
                lines.append(f"| `{parts[0]}` | {parts[2]} |")
    return "\n".join(lines)


TABLES = {"dryrun": dryrun_table, "roofline": roofline_table, "bench": bench_table}


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in TABLES:
        sys.exit(f"usage: render_tables {{{'|'.join(TABLES)}}} PATH")
    print(TABLES[sys.argv[1]](sys.argv[2]))
