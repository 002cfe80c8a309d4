"""Each cell's driver loop at a smoke size on the CPU, through the plain
kernels, called as a function (``run.py`` itself refuses the CPU)."""

import time

import pytest
import torch

from portbench.harness import spec
from portbench.harness.cell import run_cell
from portbench.tests.smoke import make_root

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("smoke"))


def _run(root, cell, trace=False, seconds=1.5, **kw):
    torch.manual_seed(0)
    c = spec.load_cell(cell, root)
    return c, run_cell(c, 2**31 + 5, seconds, trace, "cpu", time.perf_counter(),
                       time.perf_counter, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(root, cell):
    c, out = _run(root, cell)
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["check"]["judged_tokens"]["value"] >= 10
    assert list(out)[-1] == "check"
    for m in out["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("cell", ["phi3-medium-14b.decode-tiered", "phi3.5-moe-8l.decode-tiered",
                                  "phi3.5-moe-8l.chat-open"])
def test_traced_run_reports_per_layer_metrics(root, cell):
    """On the CPU the trace holds no device operation: the readers that
    need one leave their metric out, the rest report."""
    c, out = _run(root, cell, trace=True, seconds=2.0)
    assert out["correct"]
    names = {m["name"] for m in c.per_layer}
    assert set(out["metrics"]) <= names
    host_side = {"policy_ms_per_step", "migrated_pages_per_step", "prefill_ms_per_request",
                 "local_access_share", "policy_ms_per_step.host_paced",
                 "decode_tokens_per_s.host_paced"}
    assert (names & host_side) and (names & host_side) <= set(out["metrics"])
    assert "breakdown" in out
