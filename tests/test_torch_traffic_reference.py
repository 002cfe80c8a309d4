"""The port's traffic front end against the JAX package's.

The same traces (``generate_trace`` of both arrival kinds) must be equal
field for field.  The same trace served by the port's scheduler over its
``ServingEngine`` and by the JAX scheduler over the JAX engine, on the
smoke config with the JAX weights converted by ``params_from_jax``, in
float32 on the CPU, must give equal ``summary()``, ``completed`` tokens
and engine ``stats()`` — not close: relief ``none``/``shed``/``control``
× Poisson/MMPP on the batched plane, and MMPP-``control`` on the
reference plane.  The engine and traces are the traffic benchmark's
quick runs (24 requests; top-4 page selection, so page scores steer the
tier hits and the summaries follow the weights).  Last, the port's
``traffic_bench.run(quick=True)`` ends as the JAX benchmark's does: the
same lines and JSON, or the same failed acceptance bar.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks import traffic_bench as jax_bench  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.traffic import BurstyArrivals as JaxBursty  # noqa: E402
from repro.traffic import ClassMix as JaxClassMix  # noqa: E402
from repro.traffic import PoissonArrivals as JaxPoisson  # noqa: E402
from repro.traffic import TrafficConfig as JaxTrafficConfig  # noqa: E402
from repro.traffic import TrafficScheduler as JaxTrafficScheduler  # noqa: E402
from repro.traffic import generate_trace as jax_generate_trace  # noqa: E402
from repro_torch.benchmarks import traffic_bench as bench  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402
from repro_torch.traffic import (  # noqa: E402
    BurstyArrivals,
    ClassMix,
    PoissonArrivals,
    generate_trace,
)

ARCH = "tinyllama-1.1b"
# the benchmark's quick runs (benchmarks/traffic_bench.py:98)
N_QUICK = 24


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_smoke_config(ARCH), tparams


@pytest.fixture(scope="module")
def jax_runs(models):
    """Each JAX run once per module: the JAX engines share their compile."""
    jcfg, jparams, _, _ = models
    cache = {}

    def run(kind, relief, plane):
        key = (kind, relief, plane)
        if key not in cache:
            eng = jax_bench._engine(jcfg, jparams)
            if plane != "batched":
                eng = JaxServingEngine(
                    jcfg, jparams, dataclasses.replace(eng.ecfg, data_plane=plane), seed=0)
            trace = jax_generate_trace(jax_bench._arrivals(kind), seed=jax_bench.SEED,
                                       vocab=jcfg.vocab, max_requests=N_QUICK)
            sched = JaxTrafficScheduler(eng, trace, JaxTrafficConfig(
                relief=relief, pause_steps=4, evict_backoff_steps=10))
            res = sched.run()
            cache[key] = (res.summary(), sched.completed, res.engine_stats)
        return cache[key]

    return run


def port_run(models, kind, relief, plane):
    _, _, cfg, tparams = models
    sched = bench.scheduler(
        cfg, tparams, bench.trace(kind, cfg.vocab, N_QUICK), relief,
        ecfg=dataclasses.replace(bench.ENGINE_CONFIG, data_plane=plane), device="cpu")
    res = sched.run()
    return res.summary(), sched.completed, res.engine_stats


def fields(trace):
    return [dataclasses.astuple(r) for r in trace]


@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_benchmark_traces_equal_jax(kind):
    for seed, n in ((bench.SEED, bench.N_REQUESTS), (11, 20), (3, 200)):
        want = jax_generate_trace(jax_bench._arrivals(kind), seed=seed, vocab=32000,
                                  max_requests=n)
        got = generate_trace(bench.arrivals(kind), seed=seed, vocab=32000, max_requests=n)
        assert fields(got) == fields(want)
        assert len(want) == n
    assert bench.trace(kind, 32000) == generate_trace(
        bench.arrivals(kind), seed=bench.SEED, vocab=32000, max_requests=bench.N_REQUESTS)


@pytest.mark.parametrize("make", [
    pytest.param(lambda P, B: P(30.0), id="poisson-30"),
    pytest.param(lambda P, B: B(60.0, mean_burst=1.0, mean_idle=2.0), id="mmpp-idle-0"),
    pytest.param(lambda P, B: B(80.0, idle_rate=5.0, mean_burst=1.0, mean_idle=3.0),
                 id="mmpp-idle-5"),
])
def test_horizon_traces_and_mixes_equal_jax(make):
    """Horizon-bounded traces, with the default mix and a two-class mix of
    other ranges: times, tenants, classes, prompts and ``max_new``."""
    mix = (ClassMix("latency_critical", 3, 0.2, prompt_len=(2, 5), max_new=(1, 3)),
           ClassMix("batch", 1, 0.8, prompt_len=(30, 60), max_new=(20, 40)))
    jmix = tuple(JaxClassMix(**dataclasses.asdict(m)) for m in mix)
    proc, jproc = make(PoissonArrivals, BurstyArrivals), make(JaxPoisson, JaxBursty)
    for seed in (0, 5, 11):
        got = generate_trace(proc, seed=seed, vocab=64, horizon=8.0)
        assert fields(got) == fields(jax_generate_trace(jproc, seed=seed, vocab=64,
                                                        horizon=8.0))
        assert len(got) > 0
        got = generate_trace(proc, seed=seed, vocab=1000, horizon=5.0, max_requests=30,
                             mix=mix)
        assert fields(got) == fields(jax_generate_trace(
            jproc, seed=seed, vocab=1000, horizon=5.0, max_requests=30, mix=jmix))
    if isinstance(proc, BurstyArrivals):
        assert proc.mean_rate == jproc.mean_rate


def test_engine_config_is_the_jax_benchmarks(models):
    jcfg, jparams, _, _ = models
    want = dataclasses.asdict(jax_bench._engine(jcfg, jparams).ecfg)
    got = dataclasses.asdict(bench.ENGINE_CONFIG)
    assert got == want
    assert (bench.SEED, bench.N_REQUESTS, bench.RATE, bench.CLASSES,
            bench.RELIEF_MODES) == (jax_bench.SEED, jax_bench.N_REQUESTS, jax_bench.RATE,
                                    jax_bench.CLASSES, jax_bench.RELIEF_MODES)


@pytest.mark.parametrize("plane,kind,relief", [
    *[("batched", k, r) for k in ("poisson", "bursty") for r in ("none", "shed", "control")],
    ("reference", "bursty", "control"),
])
def test_scheduler_matches_jax(models, jax_runs, plane, kind, relief):
    want = jax_runs(kind, relief, plane)
    got = port_run(models, kind, relief, plane)
    summary, completed, stats = got
    assert summary == want[0]
    assert completed == want[1]
    assert stats == want[2]
    assert len(completed) == N_QUICK - summary["drops"]
    if relief == "control":
        assert summary["evictions"] + summary["pauses"] > 0, "relief must act"


def test_planes_serve_the_same_tokens(models, jax_runs):
    """The port's reference plane gives its batched plane's tokens and
    summary on the MMPP-``control`` trace (both equal JAX's above)."""
    ref = port_run(models, "bursty", "control", "reference")
    bat = port_run(models, "bursty", "control", "batched")
    assert ref[:2] == bat[:2]


def test_bench_run_quick_matches_jax(models, jax_runs, tmp_path, monkeypatch):
    """The four runs of each benchmark are the batched cases above; their
    summaries give the lines, the JSON and the acceptance bar.  On this
    tree the JAX benchmark's bar fails for Poisson arrivals (victims
    2.6173 rps against shed-only 3.139): the port must fail it alike and
    write nothing.  The JAX benchmark writes ``BENCH_traffic.json`` into
    the working directory, so it runs in ``tmp_path``; the port writes
    only where ``out`` says."""
    jcfg, jparams, _, tparams = models
    # the port's benchmark seeds its own weights: give it the JAX ones
    monkeypatch.setattr(port_model, "init_params", lambda cfg, gen, device: tparams)
    for kind in bench.KINDS:
        for relief in bench.RELIEF_MODES.values():
            assert port_run(models, kind, relief, "batched")[0] == \
                jax_runs(kind, relief, "batched")[0]
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "port.json"
    ends = []
    for fn in (lambda: jax_bench.run(quick=True),
               lambda: bench.run(quick=True, smoke=True, device="cpu", out=str(out))):
        try:
            ends.append(("lines", fn()))
        except AssertionError as exc:
            ends.append(("acceptance bar failed", str(exc)))
    assert ends[1] == ends[0]
    if ends[0][0] == "lines":
        assert json.loads(out.read_text()) == json.loads(
            (tmp_path / "BENCH_traffic.json").read_text())
    else:
        assert list(tmp_path.iterdir()) == []
