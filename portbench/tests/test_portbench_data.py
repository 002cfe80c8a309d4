"""The benchmark is driven by data: a new configuration, cell and
per-layer metric are new files and new entries, and ``run.py`` lists and
loads them with no edit to a file that was there."""

import hashlib
import json
import subprocess
import sys
import time

from portbench.harness import spec
from portbench.harness.cell import run_cell
from portbench.tests.smoke import make_root

NEW_METRIC = '''"""Steps a second over the traced window (a metric added as a file)."""


def read(ctx):
    return ctx.window_steps / ctx.trace.window_s if ctx.window_steps else None
'''


def _hashes(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_cell_and_metric_are_files_and_entries(tmp_path):
    root = make_root(tmp_path)
    before = _hashes(root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "phi3-medium-14b.json").read_text())
    cfg.update(name="phi3-medium-14b-1l", num_hidden_layers=1)
    (pb / "configs" / "phi3-medium-14b-1l.json").write_text(json.dumps(cfg))
    w = json.loads((pb / "workloads" / "phi3-medium-14b.decode-tiered.json").read_text())
    w.update(output_len=[8, 24])
    (pb / "workloads" / "phi3-medium-14b-1l.decode-short.json").write_text(json.dumps(w))
    (pb / "metrics" / "steps_per_s.py").write_text(NEW_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "phi3-medium-14b-1l", "source": cfg["source"],
                             "file": "portbench/configs/phi3-medium-14b-1l.json",
                             "reduced": cfg["reduced"] + ["num_hidden_layers"], "why": "a test"})
    bench["workloads"].append({"name": "phi3-medium-14b-1l.decode-short",
                               "config": "phi3-medium-14b-1l", "traffic": "decode-short",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:  # the new cell reports decode_tokens_per_s
        if m["name"] == "decode_tokens_per_s":
            m["workloads"].append("phi3-medium-14b-1l.decode-short")
    bench["per_layer"].append({"name": "steps_per_s", "unit": "steps/s", "better": "higher",
                               "source": "program_counter", "layer": "engine front end",
                               "moves": "decode_tokens_per_s",
                               "workloads": ["phi3-medium-14b-1l.decode-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _hashes(root)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {root.joinpath("BENCHMARK.json").relative_to(root)}

    listed = subprocess.run([sys.executable, str(pb / "run.py"), "--list"], cwd=root,
                            capture_output=True, text=True, check=True).stdout
    line = next(l for l in listed.splitlines() if l.startswith("phi3-medium-14b-1l.decode-short"))
    assert "steps_per_s" in line.split()

    cell = spec.load_cell("phi3-medium-14b-1l.decode-short", root)
    assert cell.config["num_hidden_layers"] == 1
    out = run_cell(cell, 3, 1.5, True, "cpu", time.perf_counter(), time.perf_counter)
    assert out["correct"]
    assert out["metrics"]["steps_per_s"]["value"] > 0
