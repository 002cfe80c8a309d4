"""The port's own spans (``repro_torch.spans``) on the CPU, at smoke size.

Under ``torch.profiler`` a batched decode step records each of its phase
spans once, the placement spans at their calls, a prefill its two parts,
and the MoE its four stages once a layer a forward, each inside the
forward that ran it.  With the profiler on or off the engine serves the
same tokens and counts the same placement; off, ``span()`` never reaches
``record_function``.  ``NAMES`` lists what the spans record, and no span
shares a name with the benchmark's own.
"""

import pytest

torch = pytest.importorskip("torch")

from portbench.harness.trace import read_chrome_trace  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import TppConfig  # noqa: E402
from repro_torch.launch.serve import lifecycle_trace  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.spans import NAMES  # noqa: E402

ARCHS = ("tinyllama-1.1b", "phi3.5-moe-42b-a6.6b")
PHASES = ("engine.score", "engine.select", "engine.tables", "engine.h2d",
          "engine.forward", "engine.d2h", "policy.step")
TEST_STEP = "test.step"


def engine(arch):
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ecfg = EngineConfig(page_size=4, num_fast=10, num_slow=64, recent_pages=1,
                        topk_pages=2, tpp=TppConfig(demote_budget=16, promote_budget=8))
    return cfg, ServingEngine(cfg, params, ecfg, seed=0, device="cpu")


def lifecycle(arch, profiled):
    """``lifecycle_trace`` on a fresh engine; with ``profiled``, under the
    profiler with each step inside a ``test.step`` span, and the events."""
    cfg, eng = engine(arch)
    if not profiled:
        return cfg, eng, lifecycle_trace(eng, cfg.vocab), None
    step = eng.step

    def marked():
        with torch.profiler.record_function(TEST_STEP):
            return step()

    eng.step = marked
    flushes = eng.kv.flushes
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trace = lifecycle_trace(eng, cfg.vocab)
    # the Chrome trace, as the benchmark reads it (portbench/harness/trace.py)
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in read_chrome_trace(prof)
             if e.get("cat") == "user_annotation"]
    return cfg, eng, trace, (spans, eng.kv.flushes - flushes)


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    return request.param, lifecycle(request.param, True), lifecycle(request.param, False)


def inside(spans, name, outer):
    """Spans of ``name`` within the interval ``outer``."""
    return [s for s in spans if s[0] == name and outer[1] <= s[1] and s[2] <= outer[2]]


def test_spans_nest_and_count(runs):
    arch, (cfg, eng, _, (spans, flushes)), _ = runs
    recorded = {s[0] for s in spans} - {TEST_STEP}
    if arch == "tinyllama-1.1b":
        assert recorded == {n for n in NAMES if not n.startswith("moe.")}
    else:
        assert recorded == set(NAMES)
    steps = [s for s in spans if s[0] == TEST_STEP]
    assert len(steps) == 26 and flushes > 0
    for st in steps:
        for name in PHASES:
            assert len(inside(spans, name, st)) == 1, name
    assert sum(1 for s in spans if s[0] == "pool.end_interval") == 26 // 4
    assert sum(1 for s in spans if s[0] == "kv.flush") == flushes
    prefills = [s for s in spans if s[0] == "engine.prefill"]
    assert len(prefills) == 3
    for pf in prefills:
        for name in ("engine.prefill.forward", "engine.prefill.write"):
            assert len(inside(spans, name, pf)) == 1
    n_moe = sum(1 for spec in eng.specs if spec.moe is not None)
    assert (n_moe > 0) == (arch != "tinyllama-1.1b")
    forwards = [s for s in spans if s[0] in ("engine.forward", "engine.prefill.forward")]
    for fw in forwards:
        for name in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine"):
            assert len(inside(spans, name, fw)) == n_moe
    stages = [s for s in spans if s[0].startswith("moe.")]
    assert len(stages) == 4 * n_moe * len(forwards)
    # no span nests inside another of its own name
    for name in NAMES:
        own = sorted((s, e) for n, s, e in spans if n == name)
        assert all(e0 <= s1 for (_, e0), (s1, _) in zip(own, own[1:])), name


def test_profiler_changes_no_output(runs):
    _, (_, _, on, _), (_, _, off, _) = runs
    assert on["tokens"] == off["tokens"]
    assert on["vmstat"] == off["vmstat"]
    assert on["stats"] == off["stats"]


def test_spans_are_free_with_the_profiler_off(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    cfg, eng = engine("phi3.5-moe-42b-a6.6b")
    assert lifecycle_trace(eng, cfg.vocab)["tokens"]


def test_names_are_not_the_benchmarks():
    """The benchmark keeps one interval list a span name: a program span
    of a harness span's name would count twice in its readers."""
    from portbench.harness import trace

    assert not set(NAMES) & set(trace.SPANS)
    assert trace.WINDOW not in NAMES
    assert len(set(NAMES)) == len(NAMES)


def test_profile_decode_gives_host_ms_by_span(tmp_path):
    from repro_torch.launch.serve import profile_decode

    cfg, eng = engine("phi3.5-moe-42b-a6.6b")
    prof = profile_decode(eng, cfg.vocab, requests=3, prompt_len=9, steps=4,
                          out_dir=str(tmp_path))
    ms = prof["span_host_ms_per_step"]
    assert set(PHASES) | {"moe.experts"} <= set(ms) <= set(NAMES)
    assert ms["engine.forward"] >= ms["moe.experts"] > 0
