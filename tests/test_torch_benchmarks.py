"""The port's benchmark suites against the JAX package's, on the CPU.

Each host-simulator suite (``repro_torch.benchmarks.<name>``), with its
rows cut to one and the vectorized engine, prints the JAX suite's lines:
the same names and the same ``derived`` fields.  Left out of the
comparison are the fields that are wall time: the ``us_per_call`` column
of every line, and ``engine_bench``'s ``pages_per_sec``, ``x<speedup>``
and ``overhead_pct`` (its names are compared, and its JSON's counts).
``serving_bench`` on smoke tinyllama with JAX's weights: both planes'
tokens and the QoS scenario's numbers equal JAX's.  ``kernel_bench`` on
the CPU prints JAX's four lines, timings aside; ``run.py`` rejects an
unknown suite and prints ``<key>/ERROR`` rows; ``roofline`` counts JAX's
model FLOPs and divides by the H100's peaks; ``perf_iterations`` has
JAX's variants.  JAX's suites write ``BENCH_*.json`` into the working
directory, so they run in ``tmp_path``; the port's run from the repo
root, which must be unchanged after them.
"""

import ast
import json
import os
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks import chameleon_heatmap as jax_chameleon  # noqa: E402
from benchmarks import engine_bench as jax_engine  # noqa: E402
from benchmarks import fig_ablation as jax_ablation  # noqa: E402
from benchmarks import qos_bench as jax_qos  # noqa: E402
from benchmarks import roofline as jax_roofline  # noqa: E402
from benchmarks import serving_bench as jax_serving  # noqa: E402
from benchmarks import table1_throughput as jax_table1  # noqa: E402
from benchmarks import table2_type_aware as jax_table2  # noqa: E402
from benchmarks import table3_tmo as jax_table3  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.qos import QosConfig as JaxQosConfig  # noqa: E402
from repro_torch.benchmarks import (  # noqa: E402
    chameleon_heatmap,
    common,
    engine_bench,
    fig_ablation,
    kernel_bench,
    perf_iterations,
    qos_bench,
    render_tables,
    roofline,
    run,
    serving_bench,
    table1_throughput,
    table2_type_aware,
    table3_tmo,
)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.dryrun import PERF  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def split(line):
    name, us, derived = line.split(",", 2)
    float(us)  # a number, not compared: wall time
    return name, derived


def root_snapshot():
    """The repo root's entries, each with its mtime."""
    return {p.name: p.stat().st_mtime_ns for p in REPO.iterdir()}


@pytest.fixture
def in_repo_root(monkeypatch):
    """Run the port's suite from the repo root; it must change nothing
    there."""
    monkeypatch.chdir(REPO)
    before = root_snapshot()
    yield
    assert root_snapshot() == before


# (suite, JAX module, port module, entry point, row list cut to one)
SUITES = {
    "table1": (jax_table1, table1_throughput, "run", "ROWS"),
    "chameleon": (jax_chameleon, chameleon_heatmap, "run", "WORKLOADS"),
    "ablations": (jax_ablation, fig_ablation, "run", None),
    "table2": (jax_table2, table2_type_aware, "run", "ROWS"),
    "table3": (jax_table3, table3_tmo, "run", None),
    "qos": (jax_qos, qos_bench, "run", None),
    "qos_controller": (jax_qos, qos_bench, "run_controller", None),
}


def suite_lines(mod, entry, rows, monkeypatch, **kwargs):
    if rows is not None:
        monkeypatch.setattr(mod, rows, getattr(mod, rows)[:1])
    if "engine" in getattr(mod, entry).__code__.co_varnames:
        kwargs["engine"] = "vectorized"
    return getattr(mod, entry)(quick=True, **kwargs)


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_host_suite_lines_match_jax(suite, monkeypatch, tmp_path):
    """The lines; for the two qos suites also the JSON: JAX's
    BENCH_qos.json, the port's ``out``, equal key for key."""
    jax_mod, port_mod, entry, rows = SUITES[suite]
    monkeypatch.chdir(tmp_path)  # JAX's qos suites write BENCH_qos.json here
    want = [split(line) for line in suite_lines(jax_mod, entry, rows, monkeypatch)]
    out = {"out": str(tmp_path / "port.json")} if port_mod is qos_bench else {}
    monkeypatch.chdir(REPO)
    before = root_snapshot()
    got = [split(line) for line in suite_lines(port_mod, entry, rows, monkeypatch, **out)]
    assert root_snapshot() == before
    assert got == want
    assert len(got) > 0
    if out:
        assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
            (tmp_path / "BENCH_qos.json").read_text())


# engine_bench's derived fields are all wall time: names and counts only
ENGINE_WALL = ("seconds", "pages_per_sec", "speedup", "baseline_seconds", "overhead_pct")


def drop_wall(tree):
    if isinstance(tree, dict):
        return {k: drop_wall(v) for k, v in tree.items() if k not in ENGINE_WALL}
    return tree


def test_engine_bench_matches_jax(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    want = [split(line)[0] for line in jax_engine.run(quick=True)]
    out = tmp_path / "engine.json"
    monkeypatch.chdir(REPO)
    before = root_snapshot()
    got = [split(line)[0] for line in engine_bench.run(quick=True, out=str(out))]
    assert root_snapshot() == before
    assert got == want
    jax_json = drop_wall(json.loads((tmp_path / "BENCH_engine.json").read_text()))
    assert drop_wall(json.loads(out.read_text())) == jax_json
    assert jax_json["tiersan"]["checks"] > 0


# --------------------------------------------------------------------- #
# serving_bench
# --------------------------------------------------------------------- #
def test_serving_bench_matches_jax():
    """Smoke tinyllama on JAX's weights: the tokens at batch 2 (the port's
    planes are held equal by the benchmark itself, so JAX's batched plane
    suffices) and both QoS scenarios' numbers (as the JAX benchmark
    rounds them)."""
    jcfg = jax_smoke_config(serving_bench.MODEL)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    report = serving_bench.measure(get_smoke_config(serving_bench.MODEL), tparams,
                                   quick=True, device="cpu")
    _, want = jax_serving._decode_run(jcfg, jparams, "batched", 2, 8)
    want = {r: [int(t) for t in ts] for r, ts in want.items()}
    for plane in ("reference", "batched"):
        got = report["tokens"][2][plane]
        assert {r: [int(t) for t in ts] for r, ts in got.items()} == want
    qos = report["payload"]["qos_noisy_neighbor"]
    for label, cfg in (("tenant_blind", None),
                       ("qos", JaxQosConfig(mode="static", promote_tokens_per_interval=16.0))):
        residency, stats = jax_serving._qos_noisy_neighbor(jcfg, jparams, cfg, qos["steps"])
        assert qos[label] == {
            "lc_fast_residency": round(residency, 4),
            "local_fraction": round(stats["local_fraction"], 4),
            "demoted": stats["demoted"],
            "promoted": stats["promoted"],
            "batch_sheds": stats["batch_sheds"],
        }
    names = [split(line)[0] for line in report["lines"]]
    assert names == ["serving/reference_b2", "serving/batched_b2", "serving/speedup_b2",
                     "serving/reference_b4", "serving/batched_b4", "serving/speedup_b4",
                     "serving/qos_tenant_blind", "serving/qos_qos"]


def test_serving_bench_writes_only_out(in_repo_root, tmp_path):
    out = tmp_path / "serving.json"
    lines = serving_bench.run(quick=True, smoke=True, device="cpu", out=str(out))
    payload = json.loads(out.read_text())
    assert payload["batch_sizes"] == [2, 4] and payload["device"] == "cpu"
    assert len(lines) == 8


# --------------------------------------------------------------------- #
# kernel_bench, run.py
# --------------------------------------------------------------------- #
def test_kernel_bench_cpu_lines_match_jax(in_repo_root):
    src = (REPO / "benchmarks" / "kernel_bench.py").read_text()
    want = re.findall(r'out\.append\(f"(kernel/[^,]+),\{us:\.1f\},([^"]+)"\)', src)
    assert len(want) == 4
    assert [split(line) for line in kernel_bench.run(device="cpu")] == want


def test_kernel_bench_bounds():
    """Each case's bound is its bytes at 3.35 TB/s or FLOPs at 67
    TFLOP/s; the flash case's FLOPs count the causal pairs only."""
    cases = {c.name: c for c in kernel_bench.cases("cpu")}
    flash = cases["kernel/flash_attention_512"]
    assert flash.flops == 4.0 * 64 * 8 * (512 * 513 // 2)
    for c in cases.values():
        us, by = kernel_bench.bound_us(c)
        assert us == max(c.nbytes / 3.35e12, c.flops / 67e12) * 1e6
        assert by == ("bytes" if c.nbytes / 3.35e12 >= c.flops / 67e12 else "operations")
    assert cases["kernel/page_gather_32"].nbytes == 2 * 32 * 16 * 64 * 4 + 32 * 4
    # the plain version is what runs for a CPU tensor
    for c in cases.values():
        got, want = c.call("ref"), c.call("ref")
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            c.call("kernel")


def test_run_rejects_unknown_suite(capsys):
    with pytest.raises(SystemExit) as e:
        run.main(["--only", "table2,nope"])
    assert e.value.code == 2
    assert "unknown suite(s) ['nope']" in capsys.readouterr().err


def test_run_prints_error_rows_and_exits_after_the_sweep(monkeypatch, capsys, in_repo_root):
    monkeypatch.setattr(table2_type_aware, "ROWS", table2_type_aware.ROWS[:1])
    monkeypatch.setattr(run, "MODULES", [
        ("broken", "repro_torch.benchmarks.no_such_suite", False, "run"),
        ("kernels", "repro_torch.benchmarks.kernel_bench", False, "run"),
        ("table2", "repro_torch.benchmarks.table2_type_aware", False, "run"),
        ("roofline", "repro_torch.benchmarks.roofline", True, "run"),
    ])
    with pytest.raises(SystemExit) as e:
        run.main(["--quick", "--engine", "vectorized", "--device", "meta"])
    assert "broken,kernels" in str(e.value.code)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[1].startswith("broken/ERROR,0.0,ModuleNotFoundError:")
    assert out[2].startswith("kernels/ERROR,0.0,")  # no kernel and no plain path on meta
    assert [split(line)[0] for line in out[3:5]] == [
        "table2/web_2:1_aware=False", "table2/web_2:1_aware=True"]
    assert out[5].startswith("roofline/missing,0.0,")


def test_run_passes_options_by_signature(monkeypatch, capsys, tmp_path, in_repo_root):
    """``--device`` to kernel_bench, ``--engine`` to table2, ``--out DIR``
    as ``DIR/<module>.json`` to qos and qos_controller (one file)."""
    seen = {}

    def fake_kernels(quick=False, device="cuda"):
        seen["kernels"] = (quick, device)
        return []

    monkeypatch.setattr(kernel_bench, "run", fake_kernels)
    monkeypatch.setattr(table2_type_aware, "ROWS", table2_type_aware.ROWS[:1])
    run.main(["--quick", "--only", "kernels,table2,qos,qos_controller", "--device", "cpu",
              "--engine", "vectorized", "--out", str(tmp_path / "json")])
    assert seen["kernels"] == (True, "cpu")
    assert sorted(os.listdir(tmp_path / "json")) == ["qos_bench.json"]
    payload = json.loads((tmp_path / "json" / "qos_bench.json").read_text())
    assert payload["engine"] == "vectorized" and "controller" in payload
    assert "/ERROR" not in capsys.readouterr().out


# --------------------------------------------------------------------- #
# roofline, render_tables, perf_iterations
# --------------------------------------------------------------------- #
def test_model_flops_matches_jax():
    for arch, shape in (("phi3.5-moe-42b-a6.6b", "train_4k"), ("tinyllama-1.1b", "decode_32k")):
        assert roofline.model_flops(arch, shape, 256) == jax_roofline.model_flops(arch, shape, 256)


# one cell of the port's dry-run (xlstm-350m decode_32k, 16x16), with a
# 2x16x16 row (not the single-pod mesh: left out) and a skipped cell
CELL = {"arch": "xlstm-350m", "shape": "decode_32k", "mesh": "16x16", "status": "ok",
        "trace_s": 0.8, "flops": 7053803520.0, "bytes_accessed": 9029967280.0,
        "collective_bytes": {"all-reduce": 16384, "all-gather": 704643072},
        "collective_total": 704659456, "n_devices": 256, "act_peak_est": 0,
        "cost_mode": "traced", "argument_size_in_bytes": 884292288,
        "output_size_in_bytes": 1000}


def test_roofline_uses_the_h100_constants(tmp_path, in_repo_root):
    path = tmp_path / "dryrun.json"
    skipped = {"arch": "tinyllama-1.1b", "shape": "long_500k", "mesh": "16x16",
               "status": "skipped", "reason": "pure full-attention arch"}
    path.write_text(json.dumps([CELL, dict(CELL, mesh="2x16x16", flops=1.0), skipped]))
    ok, skip = roofline.analyze(str(path))
    assert skip == {"arch": "tinyllama-1.1b", "shape": "long_500k", "status": "skipped"}
    assert (common.PEAK_FLOPS["bfloat16"], common.HBM_BYTES_PER_S,
            common.NET_BYTES_PER_S) == (989e12, 3.35e12, 50e9)
    assert ok["t_compute_s"] == CELL["flops"] / 989e12
    assert ok["t_memory_s"] == CELL["bytes_accessed"] / 3.35e12
    assert ok["t_collective_s"] == CELL["collective_total"] / 50e9
    assert ok["bottleneck"] == "collective"
    mf = jax_roofline.model_flops("xlstm-350m", "decode_32k", 256)
    assert ok["model_flops"] == mf
    assert ok["roofline_frac"] == (mf / 989e12) / ok["t_collective_s"]
    assert roofline.terms(CELL) == {"t_compute": ok["t_compute_s"],
                                    "t_memory": ok["t_memory_s"],
                                    "t_collective": ok["t_collective_s"]}
    lines = roofline.run(dryrun=str(path))
    assert lines == [
        "roofline/xlstm-350m/decode_32k,0.0,compute=7.13e-06;memory=2.70e-03;"
        "collective=1.41e-02;bound=collective;useful=0.066;roofline=0.000",
        "roofline/tinyllama-1.1b/long_500k,0.0,skipped"]
    assert roofline.run()[0].startswith("roofline/missing,0.0,")
    table = render_tables.dryrun_table(str(path)).splitlines()
    assert "trace s" in table[0] and "XLA temp" in table[0]
    assert table[2] == ("| tinyllama-1.1b | long_500k | skip | skip | — | — | — | — |")
    assert table[3] == ("| xlstm-350m | decode_32k | ✓ (0.8s) | ✓ (0.8s) | 884.3M | 0K | — "
                        "| 704.7M |")
    assert render_tables.roofline_table(str(path)).splitlines()[2].startswith(
        "| tinyllama-1.1b | long_500k | — |")


def test_perf_iterations_variants_match_jax(monkeypatch):
    tree = ast.parse((REPO / "benchmarks" / "perf_iterations.py").read_text())
    jax_variants = next(n.value for n in tree.body if isinstance(n, ast.AnnAssign)
                        and n.target.id == "VARIANTS")
    assert list(perf_iterations.VARIANTS) == [k.value for k in jax_variants.keys]
    monkeypatch.setattr(attention, "DEFAULT_KV_CHUNK", attention.DEFAULT_KV_CHUNK)
    for key in list(PERF):
        monkeypatch.setitem(PERF, key, PERF[key])
    perf_iterations.VARIANTS["all_train_opts"]()
    assert PERF == {"ce_onehot": True, "ce_chunk_override": None,
                    "remat_policy": "dots", "moe_ep": True}
    perf_iterations.VARIANTS["kv_chunk_512"]()
    assert attention.DEFAULT_KV_CHUNK == 512
    assert PERF == {"ce_onehot": True, "ce_chunk_override": None,
                    "remat_policy": None, "moe_ep": False}
    perf_iterations.VARIANTS["baseline"]()
    assert attention.DEFAULT_KV_CHUNK == 1024
