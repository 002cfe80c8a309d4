"""The benchmark's data: ``BENCHMARK.json``, the configuration and workload
files and the per-layer metric readers, all found by name.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json`` (the file
``BENCHMARK.json`` names) and ``workloads/<cell>.json``; a per-layer
metric ``<name>`` is read by ``metrics/<name>.py``'s ``read(ctx)``.  A
later change adds a configuration, a cell or a metric as new files and
entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with its configuration, traffic and the
    metrics it reports."""

    name: str
    config: Dict[str, Any]
    workload: Dict[str, Any]
    chips: int
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    root: Path = ROOT


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises ``KeyError``
    for a cell the file does not list."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    centry = configs[w["config"]]
    config = json.loads((root / centry["file"]).read_text())
    workload = json.loads(
        (root / BENCH_DIR.name / "workloads" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _applies(m, name) and m["moves"] in reported]
    return Cell(name=name, config=config, workload=workload,
                chips=int(w["chips"]), end_to_end=e2e, per_layer=layer, root=root)


def metric_reader(name: str, root: Path = ROOT) -> Callable[[Any], Optional[float]]:
    """``read(ctx)`` of ``metrics/<name>.py``: the metric's value, or None
    where the run gave it nothing to read."""
    path = root / BENCH_DIR.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
