"""The trace reduction on hand-made profiler events."""

import pytest

from portbench.harness.trace import TraceSummary


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    ev("user_annotation", "portbench.window", 0, 1000),
    ev("user_annotation", "step", 100, 300), ev("user_annotation", "step", 500, 300),
    ev("user_annotation", "policy", 350, 40), ev("user_annotation", "moe", 150, 50),
    ev("user_annotation", "admit", 850, 100),
    ev("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=1),
    ev("cuda_runtime", "cudaLaunchKernel", 160, 5, corr=2),
    ev("cuda_runtime", "cudaLaunchKernel", 510, 5, corr=3),
    ev("cuda_runtime", "cudaLaunchKernel", 860, 5, corr=4),
    ev("kernel", "gemm_kernel", 120, 100, corr=1),
    ev("kernel", "moe_route_kernel", 200, 50, corr=2),
    ev("gpu_memcpy", "Memcpy HtoD", 520, 30, corr=3),
    ev("kernel", "flash_attention_kernel", 870, 200, corr=4),  # runs past the window
]


def test_busy_idle_and_spans():
    t = TraceSummary(EVENTS)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s() == pytest.approx((130 + 30 + 130) / 1e6)
    assert t.n_spans("step") == 2 and t.span_s("policy") == pytest.approx(40e-6)
    assert t.device(within=("step",)) == (pytest.approx(180e-6), 3)
    assert t.device(within=("step",), kernels_only=True)[1] == 2
    assert t.device(within=("step", "moe")) == (pytest.approx(50e-6), 1)
    assert t.device(within=("admit",), name="flash_attention_kernel") == (pytest.approx(200e-6), 1)
    idle = t.idle_by_host()
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s())
    # gaps 0-120 (no span), 250-520 (middle 385 in policy), 550-870 (in a step)
    assert idle == {"host": pytest.approx(120e-6), "policy": pytest.approx(270e-6),
                    "step": pytest.approx(320e-6)}


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        TraceSummary(EVENTS[1:])
