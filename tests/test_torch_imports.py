"""The port stands alone: no JAX and nothing of the JAX package.

An AST scan of every file under ``src/repro_torch/`` and of
``chip_smoke.py`` finds no ``jax`` import and no ``repro``/``repro.*``
import, and a fresh interpreter that imports the serving engine ends
with no ``jax`` module loaded.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.JoinedStr | ast.Constant)):
            first = node.args[0]
            text = (first.value if isinstance(first, ast.Constant)
                    else "".join(v.value for v in first.values
                                 if isinstance(v, ast.Constant)))
            yield node.lineno, text


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import(path):
    bad = [(line, mod) for line, mod in imported_roots(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_covers_its_layout():
    names = {p.relative_to(REPO / "src" / "repro_torch").parts[0] for p in FILES[:-1]}
    assert {"core", "kernels", "models", "serving", "configs", "launch", "analysis",
            "qos", "traffic", "benchmarks", "fleet", "optim", "data", "checkpoint"} <= names


def test_serving_engine_import_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    code = ("import sys, repro_torch.serving.engine, repro_torch.launch.serve, "
            "repro_torch.qos, repro_torch.analysis, repro_torch.core.baselines, "
            "repro_torch.traffic, repro_torch.serving.expert_tier, "
            "repro_torch.benchmarks.traffic_bench, repro_torch.benchmarks.expert_tiering, "
            "repro_torch.fleet, repro_torch.core.simulator, "
            "repro_torch.benchmarks.fleet_bench, repro_torch.launch.train, "
            "repro_torch.optim.offload, repro_torch.checkpoint, repro_torch.data; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax')); "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
