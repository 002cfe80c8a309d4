"""What a run loads and refuses: no ``jax`` or ``repro`` module (whole
top-level names), a reference that imports nothing of the program, and
no result without a CUDA card or without the program."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CPU = dict(os.environ, CUDA_VISIBLE_DEVICES="")

RUN_SMOKE = """
import sys, time
sys.path[:0] = [{src!r}, {root!r}]
from portbench.harness import spec
from portbench.harness.cell import run_cell
from portbench.run import loaded_forbidden
c = spec.load_cell("phi3.5-moe-8l.decode-tiered", __import__("pathlib").Path({root!r}))
out = run_cell(c, 1, 1.0, False, "cpu", time.perf_counter(), time.perf_counter)
print(out["correct"], sorted(loaded_forbidden()),
      sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro")))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    from portbench.tests.smoke import make_root

    root = make_root(tmp_path)
    code = RUN_SMOKE.format(src=str(ROOT / "src"), root=str(root))
    out = subprocess.run([sys.executable, "-c", code], env=CPU, capture_output=True,
                         text=True, check=True).stdout.split("\n")[-2]
    assert out == "True [] []"


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro", "jax", "portbench"), (path, n)
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.model; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax')))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.strip()
    assert out == "[]"


def test_no_result_without_a_card():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "phi3.5-moe-8l.decode-local", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=CPU, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_no_result_with_only_the_benchmark(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "phi3.5-moe-8l.decode-local", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""
