"""The port stands alone: no JAX and nothing of the JAX package.

An AST scan of every file under ``src/repro_torch/``, of
``chip_smoke.py`` and of ``tools/moe_turns.py`` finds no ``jax`` import and no ``repro``/``repro.*``
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
PACKAGE = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
FILES = PACKAGE + [REPO / "chip_smoke.py", REPO / "tools" / "moe_turns.py"]
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
    names = {p.relative_to(REPO / "src" / "repro_torch").parts[0] for p in PACKAGE}
    assert {"core", "kernels", "models", "serving", "configs", "launch", "analysis",
            "qos", "traffic", "benchmarks", "fleet", "optim", "data", "checkpoint",
            "examples"} <= names
    launch = {p.name for p in (REPO / "src" / "repro_torch" / "launch").glob("*.py")}
    assert {"mesh.py", "shardings.py", "dryrun.py", "dryrun_update.py"} <= launch
    analysis = {p.name for p in (REPO / "src" / "repro_torch" / "analysis").glob("*.py")}
    assert {"plan_verify.py", "tiersan.py", "repro_lint.py"} <= analysis
    # every module of the JAX package's benchmarks/ has its counterpart
    jax_benchmarks = {p.name for p in (REPO / "benchmarks").glob("*.py")}
    benchmarks = {p.name for p in (REPO / "src" / "repro_torch" / "benchmarks").glob("*.py")}
    assert {"common.py", "run.py", "kernel_bench.py", "serving_bench.py",
            "table1_throughput.py", "chameleon_heatmap.py", "fig_ablation.py",
            "table2_type_aware.py", "table3_tmo.py", "engine_bench.py", "qos_bench.py",
            "roofline.py", "perf_iterations.py", "render_tables.py", "traffic_bench.py",
            "expert_tiering.py", "fleet_bench.py"} <= benchmarks
    assert jax_benchmarks <= benchmarks
    # file by file, the JAX package has no module the port lacks, but
    # kernels/ref.py: each port kernel module holds its own plain version
    jax_tree = {p.relative_to(REPO / "src" / "repro").as_posix()
                for p in (REPO / "src" / "repro").rglob("*.py")}
    port_tree = {p.relative_to(REPO / "src" / "repro_torch").as_posix() for p in PACKAGE}
    assert jax_tree - port_tree == {"kernels/ref.py"}


def test_serving_engine_import_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    code = ("import sys, repro_torch.serving.engine, repro_torch.launch.serve, "
            "repro_torch.qos, repro_torch.analysis, repro_torch.core.baselines, "
            "repro_torch.traffic, repro_torch.serving.expert_tier, "
            "repro_torch.benchmarks.traffic_bench, repro_torch.benchmarks.expert_tiering, "
            "repro_torch.fleet, repro_torch.core.simulator, "
            "repro_torch.benchmarks.fleet_bench, repro_torch.launch.train, "
            "repro_torch.optim.offload, repro_torch.checkpoint, repro_torch.data, "
            "repro_torch.configs.deepseek_v2_lite_16b, repro_torch.launch.generate, "
            "repro_torch.models.ssm, repro_torch.configs.zamba2_2_7b, "
            "repro_torch.configs.xlstm_350m, repro_torch.examples.quickstart, "
            "repro_torch.examples.serve_tiered, repro_torch.examples.train_e2e, "
            "repro_torch.launch.mesh, repro_torch.launch.shardings, "
            "repro_torch.launch.dryrun, repro_torch.launch.dryrun_update, "
            "repro_torch.analysis.repro_lint, repro_torch.benchmarks.run, "
            "repro_torch.benchmarks.kernel_bench, repro_torch.benchmarks.serving_bench, "
            "repro_torch.benchmarks.table1_throughput, "
            "repro_torch.benchmarks.chameleon_heatmap, repro_torch.benchmarks.fig_ablation, "
            "repro_torch.benchmarks.table2_type_aware, repro_torch.benchmarks.table3_tmo, "
            "repro_torch.benchmarks.engine_bench, repro_torch.benchmarks.qos_bench, "
            "repro_torch.benchmarks.roofline, repro_torch.benchmarks.perf_iterations, "
            "repro_torch.benchmarks.render_tables; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax')); "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
