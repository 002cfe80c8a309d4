"""The port's host simulator against ``repro.core``'s.

``repro_torch.core.trace``, ``chameleon``, ``engine`` and ``simulator``
are copies of the JAX package's modules.  On the same seeds they must
give equal results, compared exactly (integers, and floats with ``==``):

* ``make_trace`` steps for every ``WORKLOADS`` entry and a two-tenant
  mix, and ``record_trace`` replays;
* ``Chameleon``'s interval summaries and insights on one access stream;
* ``_FrameStack`` and ``VectorPagePool`` against both JAX pools — the
  cases of ``tests/test_engine_parity.py`` (all but the CPU-timed
  100k-page speedup test), each run through the port's two engines and
  the JAX package's two;
* ``TieredSimulator``'s ``summary()`` and ``vmstat.as_dict()`` for every
  policy × both engines × single-tenant, multi-tenant and ``QosConfig``
  runs, and ``run_policy_comparison``.
"""

import dataclasses
import enum

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.qos as jqos  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.qos as tqos  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import trace as jtrace  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import trace as ttrace  # noqa: E402

POLICIES = ("tpp", "linux", "numa_balancing", "autotiering")
ENGINES = ("reference", "vectorized")
PACKAGES = {"jax": (jcore, jqos), "torch": (tcore, tqos)}


def plain(x):
    """Enums → ints, dataclasses → dicts, numpy → lists, recursively, so
    the two packages' values (whose enum classes differ) compare with ==."""
    if isinstance(x, enum.Enum):
        return int(x.value)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


# --------------------------------------------------------------------- #
# traces
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(jtrace.WORKLOADS) + ["web+cache1"])
def test_make_trace_steps_equal(name, seed):
    total = 300 if "+" not in name else 400
    jt = jcore.make_trace(name, seed=seed, total_pages=total)
    tt = tcore.make_trace(name, seed=seed, total_pages=total)
    assert type(jt).__name__ == type(tt).__name__
    for _ in range(8):
        assert plain(next(jt)) == plain(next(tt))
    if "+" in name:
        assert jt.n_tenants == tt.n_tenants
        idx = np.arange(0, 2000, 7)
        assert jt.tenant_of_array(idx).tolist() == tt.tenant_of_array(idx).tolist()
    assert jcore.workload_total_pages(name) == tcore.workload_total_pages(name)
    assert plain(jtrace.WORKLOADS) == plain(ttrace.WORKLOADS)


def test_record_trace_replays():
    jr = jcore.record_trace(jcore.make_trace("web+cache1", seed=3, total_pages=400), 12)
    tr = tcore.record_trace(tcore.make_trace("web+cache1", seed=3, total_pages=400), 12)
    assert len(jr) == len(tr) == 12
    first = [plain(s) for s in tr]
    assert first == [plain(s) for s in jr]
    assert [plain(s) for s in tr.reset()] == first  # a replay is the same trace
    with pytest.raises(StopIteration):
        next(tr)
    assert tr.n_tenants == jr.n_tenants == 2


def test_unknown_workload_raises_alike():
    for core in (jcore, tcore):
        with pytest.raises(ValueError, match="unknown workload"):
            core.make_trace("nope")
        with pytest.raises(ValueError, match="unknown workload"):
            core.make_trace("web+nope")


# --------------------------------------------------------------------- #
# the §3 profiler
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("sample_rate,duty_cycle", [(1.0, 1.0), (0.3, 0.5)])
def test_chameleon_summaries_equal(sample_rate, duty_cycle):
    out = {}
    for key, core in (("jax", jcore), ("torch", tcore)):
        trace = core.make_trace("web", seed=5, total_pages=300)
        cham = core.Chameleon(sample_rate=sample_rate, duty_cycle=duty_cycle, seed=11)
        types = {}
        summaries = []
        for step in range(24):
            s = next(trace)
            types.update(dict(s.allocs))
            cham.record((pid, types[pid]) for pid in s.accesses if pid in types)
            for pid in s.frees:
                cham.note_free(pid)
                types.pop(pid, None)
            if step % 3 == 2:
                summaries.append(plain(cham.end_interval()))
        out[key] = (summaries, plain(cham.temperature_fractions()),
                    cham.idle_fraction(), cham.reaccess_cdf().tolist(),
                    cham.heatmap(intervals=8, bins=16).tolist(),
                    plain(cham.usage_over_time()), cham.total_samples)
    assert out["jax"] == out["torch"]
    assert out["torch"][-1] > 0


# --------------------------------------------------------------------- #
# the vectorized engine's frame stack
# --------------------------------------------------------------------- #
def test_frame_stack_equal():
    rng = np.random.default_rng(0)
    js, ts = jengine._FrameStack(16), tengine._FrameStack(16)
    for _ in range(200):
        op = rng.integers(0, 4)
        if op == 0 and len(js):
            assert js.pop() == ts.pop()
        elif op == 1:
            k = int(rng.integers(0, len(js) + 1))
            assert js.pop_many(k).tolist() == ts.pop_many(k).tolist()
        elif op == 2:
            f = int(rng.integers(0, 64))
            js.push(f)
            ts.push(f)
        else:
            fr = rng.integers(0, 64, size=int(rng.integers(0, 9)))
            js.push_many(fr)
            ts.push_many(fr)
        assert len(js) == len(ts)
    for s in (js, ts):
        with pytest.raises(ValueError, match="pop_many"):
            s.pop_many(len(s) + 1)
    empty = tengine._FrameStack(0)
    with pytest.raises(IndexError):
        empty.pop()


# --------------------------------------------------------------------- #
# tests/test_engine_parity.py's cases: four engines, one answer
# --------------------------------------------------------------------- #
def result_view(res):
    return (res.vmstat.as_dict(), res.summary(), plain(res.per_tenant),
            res.local_fraction, res.promote_rate, res.demote_rate,
            res.alloc_fast_rate, plain(res.qos))


def run_all(workload, policy, fast, slow, cfg_kw=None, steps=24, total=None, seed=7,
            measure_from=8, qos=None):
    """(package, engine) → the run's observable fields."""
    out = {}
    for key, (core, qosmod) in PACKAGES.items():
        for engine in ENGINES:
            sim = core.TieredSimulator(
                workload, policy, fast, slow,
                config=core.TppConfig(**cfg_kw) if cfg_kw else None, seed=seed,
                trace=core.make_trace(workload, seed=seed, total_pages=total),
                engine=engine, qos=qos(qosmod) if qos else None,
            )
            out[key, engine] = result_view(sim.run(steps, measure_from=measure_from))
    return out


def assert_all_equal(out):
    first = out["jax", "reference"]
    for key, view in out.items():
        assert view == first, key
    return first


@pytest.mark.parametrize("policy", POLICIES)
def test_parity_single_tenant(policy):
    assert_all_equal(run_all("cache1", policy, 96, 512, total=400))


def test_parity_ideal():
    assert_all_equal(run_all("cache1", "ideal", 1200, 0, total=400))


@pytest.mark.parametrize("policy", POLICIES)
def test_parity_multi_tenant(policy):
    view = assert_all_equal(run_all("web+data_warehouse", policy, 300, 1200, total=800))
    per_tenant = view[2]
    assert set(per_tenant) == {0, 1}
    for acc in per_tenant.values():
        assert acc["access_fast"] + acc["access_slow"] > 0


def test_parity_under_memory_exhaustion():
    """Eviction fallback + refault path (both tiers overcommitted)."""
    for policy in ("tpp", "linux", "autotiering"):
        view = assert_all_equal(run_all("data_warehouse", policy, 64, 128, total=220))
        assert view[0]["pswpout"] > 0  # the path was actually exercised


def test_parity_unknown_access_index():
    """Accesses to never-allocated indices are skipped by every engine."""
    out = {}
    for key, (core, _) in PACKAGES.items():
        PT = core.PageType
        steps = [
            jtrace.TraceStep(allocs=[(0, PT.ANON), (1, PT.FILE)],
                             accesses=[0, 5000, 1, 5000], frees=[77_777]),
            jtrace.TraceStep(allocs=[], accesses=[99_999, 0], frees=[1]),
        ] if core is jcore else [
            ttrace.TraceStep(allocs=[(0, PT.ANON), (1, PT.FILE)],
                             accesses=[0, 5000, 1, 5000], frees=[77_777]),
            ttrace.TraceStep(allocs=[], accesses=[99_999, 0], frees=[1]),
        ]
        for engine in ENGINES:
            sim = core.TieredSimulator("web", "tpp", 16, 16,
                                       trace=core.ReplayTrace(steps), engine=engine)
            res = sim.run(2)
            out[key, engine] = (res.vmstat.as_dict(), res.total_accesses)
    view = assert_all_equal(out)
    assert view[1] == 3  # unknown indices skipped


def test_parity_type_aware_allocation():
    """§5.4 file_to_slow flips the batched-allocation tier order."""
    view = assert_all_equal(run_all("cache1", "tpp", 96, 512,
                                    cfg_kw=dict(file_to_slow=True), total=400))
    assert view[0]["pgalloc_slow"] > 0


def test_parity_coupled_ablation_and_sampling():
    assert_all_equal(run_all("web", "tpp", 96, 512, total=400, cfg_kw=dict(
        decoupled=False, sample_rate=0.3, promote_budget=16)))


def test_parity_null_control():
    """Single-tenant runs carry the NULL_CONTROL singleton end to end."""
    for core in (jcore, tcore):
        for engine in ENGINES:
            sim = core.TieredSimulator(
                "cache1", "tpp", 96, 512, seed=7,
                trace=core.make_trace("cache1", seed=7, total_pages=400), engine=engine)
            assert sim.pool.control is core.NULL_CONTROL
    view = assert_all_equal(run_all("cache1", "tpp", 96, 512, total=400))
    assert view[0]["pgalloc_steered"] == 0


MIX3 = "web+cache1+data_warehouse"


def test_parity_arbiter_with_allocation_steering():
    view = assert_all_equal(run_all(
        MIX3, "tpp", 300, 1200, total=800,
        qos=lambda q: q.QosConfig(mode="dynamic",
                                  classes=("latency_critical", "standard", "batch"))))
    assert view[0]["pgalloc_steered"] > 0  # steering exercised


def test_parity_slowdown_controller():
    view = assert_all_equal(run_all(
        MIX3, "tpp", 300, 1200, total=800,
        qos=lambda q: q.SlowdownControllerConfig(
            qos=q.QosConfig(classes=("latency_critical", "standard", "batch")))))
    assert view[-1]["mode"] == "slowdown_controller"


@pytest.mark.parametrize("file_to_slow", [False, True])
@pytest.mark.parametrize("ptype", [0, 1])
def test_allocate_many_matches_scalar_sequence(file_to_slow, ptype):
    """try_allocate_many == n scalar allocates: tiers, stalls, counters —
    the port's vector pool against both JAX pools."""
    for n in (1, 7, 40, 90):
        ref = jcore.PagePool(64, 64, config=jcore.TppConfig(file_to_slow=file_to_slow))
        jvec = jcore.VectorPagePool(64, 64, config=jcore.TppConfig(file_to_slow=file_to_slow))
        tvec = tcore.VectorPagePool(64, 64, config=tcore.TppConfig(file_to_slow=file_to_slow))
        ref_tiers = [int(ref.allocate(jcore.PageType(ptype)).tier) for _ in range(n)]
        jplaced = jvec.try_allocate_many(jcore.PageType(ptype), n)
        tplaced = tvec.try_allocate_many(tcore.PageType(ptype), n)
        assert tplaced is not None
        assert [int(t) for t in tplaced[1]] == [int(t) for t in jplaced[1]] == ref_tiers
        assert list(tplaced[0]) == list(jplaced[0])
        assert tvec.vmstat.as_dict() == jvec.vmstat.as_dict() == ref.vmstat.as_dict()
        for tier in (0, 1):
            assert (tvec.free_frames(tcore.Tier(tier)) == jvec.free_frames(jcore.Tier(tier))
                    == ref.free_frames(jcore.Tier(tier)))
    # over-commit: the batch declines
    vec = tcore.VectorPagePool(8, 4, config=tcore.TppConfig(file_to_slow=file_to_slow))
    assert vec.try_allocate_many(tcore.PageType(ptype), 50) is None


def test_touch_many_matches_scalar_touches():
    ref = jcore.PagePool(32, 32)
    jvec, tvec = jcore.VectorPagePool(32, 32), tcore.VectorPagePool(32, 32)
    for _ in range(40):
        ref.allocate(jcore.PageType.ANON)
    jvec.try_allocate_many(jcore.PageType.ANON, 40)
    tvec.try_allocate_many(tcore.PageType.ANON, 40)
    pids = [0, 3, 3, 17, 38, 0, 0, 5]  # duplicates on purpose
    ref_tiers = [int(ref.touch(p)) for p in pids]
    jt = jvec.touch_many(np.asarray(pids, np.int64))
    tt = tvec.touch_many(np.asarray(pids, np.int64))
    assert [int(t) for t in tt] == [int(t) for t in jt] == ref_tiers
    assert tvec.vmstat.as_dict() == jvec.vmstat.as_dict() == ref.vmstat.as_dict()
    for p in set(pids):
        assert tvec.touch_count_of(p) == jvec.touch_count_of(p) == ref.pages[p].touch_count
        assert tvec.page(p).history == ref.pages[p].history
    for pool in (ref, jvec, tvec):
        pool.end_interval()
    assert tvec.page(3).history == jvec.page(3).history == ref.pages[3].history


def test_vector_pool_invariants_after_migration_storm():
    states = []
    for core in (jcore, tcore):
        vec = core.VectorPagePool(32, 64)
        policy = core.make_policy("tpp", vec)
        for _ in range(31):
            vec.allocate(core.PageType.ANON)
        for _ in range(10):
            slow = vec.pages_in_tier(core.Tier.SLOW)[:8]
            policy.step(slow)
            vec.check_invariants()
        states.append((vec.vmstat.as_dict(),
                       [int(vec.page(p).tier) for p in range(31)],
                       [vec.page(p).frame for p in range(31)]))
    assert states[0] == states[1]


def test_make_pool_engines():
    assert tcore.ENGINES == jcore.ENGINES
    assert isinstance(tengine.make_pool("vectorized", 8, 8), tcore.VectorPagePool)
    assert isinstance(tengine.make_pool("reference", 8, 8), tcore.PagePool)
    with pytest.raises(ValueError):
        tengine.make_pool("nope", 8, 8)


# --------------------------------------------------------------------- #
# TieredSimulator: every policy × both engines × three control setups
# --------------------------------------------------------------------- #
SETUPS = {
    "single": ("cache1", 96, 512, 400, None),
    "multi": ("web+cache1", 200, 900, 600, None),
    "qos": ("web+cache1", 200, 900, 600,
            lambda q: q.QosConfig(classes=("latency_critical", "batch"))),
}


@pytest.mark.parametrize("setup", sorted(SETUPS))
@pytest.mark.parametrize("policy", POLICIES + ("ideal",))
def test_simulator_summary_equal(policy, setup):
    workload, fast, slow, total, qos = SETUPS[setup]
    if policy == "ideal":
        fast, slow = fast + slow, 0
    out = {}
    for key, (core, qosmod) in PACKAGES.items():
        for engine in ENGINES:
            sim = core.TieredSimulator(
                workload, policy, fast, slow, seed=3, interval_steps=4,
                trace=core.make_trace(workload, seed=3, total_pages=total),
                engine=engine, qos=qos(qosmod) if qos else None)
            res = sim.run(20, measure_from=8)
            out[key, engine] = (res.summary(), res.vmstat.as_dict(),
                                res.tenant_summary(), res.tenant_slowdowns(),
                                res.jains_fairness(), plain(res.qos),
                                plain(sim.tenant_counters()))
    view = assert_all_equal(out)
    assert view[1]["access_fast"] + view[1]["access_slow"] > 0


def test_run_policy_comparison_equal():
    kw = dict(steps=24, seed=2, total_pages=500, measure_from=8, engine="vectorized")
    jres = jcore.run_policy_comparison("web+cache1", 150, 700, **kw)
    tres = tcore.run_policy_comparison("web+cache1", 150, 700, **kw)
    assert sorted(jres) == sorted(tres)
    for k in jres:
        assert tres[k].summary() == jres[k].summary()
        assert tres[k].vmstat.as_dict() == jres[k].vmstat.as_dict()
