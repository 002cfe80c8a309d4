"""The port's fleet control plane against ``repro.fleet``.

``repro_torch.fleet`` copies the JAX package's shards, coordinator and
fleet simulator, and re-implements the mesh over a ``gloo`` group of
local processes.  Pinned here, each against the JAX package where it
has an answer, compared exactly:

* ``tests/test_fleet.py``'s properties on the port: single-host parity
  with a plain ``TieredSimulator``, budget conservation and exact
  division, validation, ``missed_tick``, push-down to watermarks and
  quotas, TierSan's fleet laws, stable per-shard seeds, telemetry
  windows — and each run's results equal to the JAX fleet's;
* ``fleet_bench``'s quick numbers equal to the JAX benchmark's ``_run``;
* the gloo mesh: its reduction equals numpy, more rows than ranks gives
  ``None``;
* both serving pools as fleet shards (``ExpertTierManager`` and
  ``ServingEngine.as_shard_pool``);
* a two-host fleet of traffic-driven serving engines at the smoke
  config (the fleet phase of ``chip_smoke.py``) in both modes, equal to
  the same fleet built from ``repro.fleet`` over JAX engines.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.fleet as jfleet  # noqa: E402
import repro_torch.fleet as tfleet  # noqa: E402
from benchmarks import fleet_bench as jax_fleet_bench  # noqa: E402
from benchmarks import traffic_bench as jax_traffic_bench  # noqa: E402
from repro.analysis import check_fleet_conservation as jax_check_fleet  # noqa: E402
from repro.core import TieredSimulator as JaxTieredSimulator  # noqa: E402
from repro.core import make_trace as jax_make_trace  # noqa: E402
from repro.qos import QosConfig as JaxQosConfig  # noqa: E402
from repro_torch.analysis import TierSanError, check_fleet_conservation  # noqa: E402
from repro_torch.benchmarks import fleet_bench  # noqa: E402
from repro_torch.benchmarks import traffic_bench  # noqa: E402
from repro_torch.core import TieredSimulator, Tier, TppConfig, make_trace  # noqa: E402
from repro_torch.fleet import (  # noqa: E402
    FleetCoordinator,
    FleetCoordinatorConfig,
    FleetHostSpec,
    FleetPoolSpec,
    FleetSimulator,
    HostShard,
    ShardPool,
    host_device_count,
    mesh_reduce_telemetry,
    request_host_devices,
)
from repro_torch.fleet import coordinator as coordinator_mod  # noqa: E402
from repro_torch.qos import QosConfig  # noqa: E402

WORKLOAD = "web+cache1"
CLASSES = ("latency_critical", "batch")


def pool_spec(name="kv", fast=96, slow=512, total_pages=500, pkg="torch", **kw):
    spec, qos = ((FleetPoolSpec, QosConfig) if pkg == "torch"
                 else (jfleet.FleetPoolSpec, JaxQosConfig))
    return spec(name=name, workload=WORKLOAD, fast_frames=fast, slow_frames=slow,
                total_pages=total_pages, qos=qos(classes=CLASSES), **kw)


def small_fleet(n_hosts=2, mode="coordinated", budget=120, pkg="torch", **kw):
    host, sim = ((FleetHostSpec, FleetSimulator) if pkg == "torch"
                 else (jfleet.FleetHostSpec, jfleet.FleetSimulator))
    hosts = [host(pools=(pool_spec(pkg=pkg),)) for _ in range(n_hosts)]
    kw = {"coordinate_every": 8, "interval_steps": 4, "seed": 7, **kw}
    return sim(hosts, mode=mode, global_fast_budget=budget, **kw)


def fleet_view(res):
    return (res.summary(), res.vmstat, res.budgets, res.timelines,
            res.tenant_windows, res.coordinator, res.tenant_slowdowns())


# --------------------------------------------------------------------- #
# single-host parity: the fleet layer is a bit-identical wrapper
# --------------------------------------------------------------------- #
class TestSingleHostParity:
    def test_greedy_full_budget_matches_plain_simulator(self):
        steps, seed = 64, 7
        fleet = FleetSimulator(
            [FleetHostSpec(pools=(pool_spec(),))],
            mode="greedy", coordinate_every=8, interval_steps=4, seed=seed,
        )
        assert fleet.global_budget == 96  # defaults to physical capacity
        fres = fleet.run(steps)
        out = {}
        for key, sim, trace, qos in (
                ("torch", TieredSimulator, make_trace, QosConfig),
                ("jax", JaxTieredSimulator, jax_make_trace, JaxQosConfig)):
            plain = sim(WORKLOAD, "tpp", 96, 512, interval_steps=4, seed=seed,
                        trace=trace(WORKLOAD, seed=seed, total_pages=500),
                        engine="vectorized", qos=qos(classes=CLASSES))
            out[key] = plain.run(steps)
        key = "h0/kv"
        for pres in out.values():
            assert fres.vmstat[key] == pres.vmstat.as_dict()
            assert fres.timelines[key]["local_fraction"] == pres.local_fraction
            assert fres.timelines[key]["promote_rate"] == pres.promote_rate
            assert fres.timelines[key]["demote_rate"] == pres.demote_rate

    @pytest.mark.parametrize("pkg", ["torch", "jax"])
    def test_chunked_stepping_requires_interval_alignment(self, pkg):
        with pytest.raises(ValueError, match="multiple of interval_steps"):
            small_fleet(coordinate_every=6, interval_steps=4, pkg=pkg)
        with pytest.raises(ValueError, match="unknown mode"):
            small_fleet(mode="chaotic", pkg=pkg)
        fleet = small_fleet(pkg=pkg)
        with pytest.raises(ValueError, match="multiple of"):
            fleet.run(30)  # not a multiple of interval_steps
        with pytest.raises(ValueError, match="chunk boundary"):
            fleet.run(64, measure_from=10)


# --------------------------------------------------------------------- #
# budget conservation + division exactness
# --------------------------------------------------------------------- #
class TestCoordinator:
    @pytest.mark.parametrize("mode", ["greedy", "coordinated"])
    def test_fleet_runs_equal_jax(self, mode):
        views = []
        for pkg in ("torch", "jax"):
            fleet = small_fleet(budget=120, mode=mode, pkg=pkg)
            views.append(fleet_view(fleet.run(64, measure_from=16)))
        assert views[0] == views[1]

    def test_budget_conserved_across_ticks(self):
        fleet = small_fleet(budget=120)
        fleet.run(64)
        check_fleet_conservation(fleet.coordinator)
        assert fleet.coordinator.ticks == 7
        for entry in fleet.coordinator.timeline:
            assert sum(entry["budgets"]) == 120

    def test_division_exact_under_extreme_shares(self):
        coords = [small_fleet(budget=120, pkg=p).coordinator for p in ("torch", "jax")]
        for shares in ([0.999, 0.001], [0.001, 0.999], [0.5, 0.5], [0.3333, 0.6667]):
            out = []
            for coord in coords:
                coord.shares = np.asarray(shares, np.float64)
                budgets = coord.divide()
                assert int(budgets.sum()) == 120
                assert (budgets >= coord.config.min_budget).all()
                assert (budgets <= coord._physical).all()
                out.append(budgets.tolist())
            assert out[0] == out[1]

    def test_global_budget_validation(self):
        hosts = [FleetHostSpec(pools=(pool_spec(),))]
        with pytest.raises(ValueError, match="outside"):
            FleetSimulator(hosts, global_fast_budget=97)  # > physical
        with pytest.raises(ValueError, match="outside"):
            FleetSimulator(hosts, global_fast_budget=4)  # < min_budget
        with pytest.raises(ValueError, match="min_budget"):
            FleetCoordinatorConfig(min_budget=2)
        with pytest.raises(ValueError, match="gain"):
            FleetCoordinatorConfig(gain=0.0)
        with pytest.raises(ValueError, match="share_floor"):
            FleetCoordinatorConfig(share_floor=1.0)
        with pytest.raises(ValueError, match="at least one"):
            FleetCoordinator([], 8)
        sp = small_fleet().pools[0]
        with pytest.raises(ValueError, match="duplicate"):
            FleetCoordinator([sp, sp], 16)
        with pytest.raises(ValueError, match="belongs to host"):
            HostShard(1, [sp])

    def test_missed_tick_decays_toward_greedy_split(self):
        """Fault tolerance: blind rounds forget learned skew, conserve —
        and decay exactly as the JAX coordinator does."""
        runs = []
        for pkg in ("torch", "jax"):
            fleet = small_fleet(budget=120, pkg=pkg)
            coord = fleet.coordinator
            fleet.run(32)  # learn some skew from real telemetry first
            coord.shares = np.asarray([0.9, 0.1], np.float64)  # extreme skew
            coord.pressure_ewma = np.asarray([3.0, 0.2], np.float64)
            greedy = coord._physical / coord._physical.sum()
            ticks0 = coord.ticks
            gap0 = float(np.abs(coord.shares - greedy).sum())
            for _ in range(12):
                budgets = coord.missed_tick()
                assert int(budgets.sum()) == 120  # conservation holds blind
                (check_fleet_conservation if pkg == "torch" else jax_check_fleet)(coord)
                gap = float(np.abs(coord.shares - greedy).sum())
                assert gap < gap0
                gap0 = gap
            # repeated misses converge on the capacity-proportional split
            np.testing.assert_allclose(coord.shares, greedy, atol=0.05)
            np.testing.assert_allclose(coord.pressure_ewma, 1.0, atol=0.1)
            assert coord.missed_ticks == 12
            assert coord.ticks == ticks0 + 12
            missed = [e for e in coord.timeline if e.get("missed")]
            assert len(missed) == 12 and missed[-1]["tick"] == coord.ticks
            runs.append((coord.shares.tolist(), coord.pressure_ewma.tolist(),
                         coord.summary()))
        assert runs[0] == runs[1]
        # decay=1.0 snaps straight back to greedy in one miss
        cfg = FleetCoordinatorConfig(miss_decay=1.0)
        coord2 = small_fleet(budget=120, coordinator=cfg).coordinator
        coord2.shares = np.asarray([0.95, 0.05], np.float64)
        coord2.missed_tick()
        np.testing.assert_allclose(
            coord2.shares, coord2._physical / coord2._physical.sum())
        with pytest.raises(ValueError, match="miss_decay"):
            FleetCoordinatorConfig(miss_decay=0.0)

    def test_pushdown_reaches_watermarks_and_quotas(self):
        fleet = small_fleet(budget=120, mode="greedy")
        sp = fleet.pools[0]
        sp.apply_budget(60)
        pool = sp.pool
        assert pool.fast_budget == 60
        assert (pool.wm_min, pool.wm_alloc, pool.wm_demote) == \
            pool.config.frames_for_budget(96, 60)
        assert sp.control.fast_frames == 60
        # full budget restores the unbudgeted watermarks exactly
        sp.apply_budget(96)
        assert (pool.wm_min, pool.wm_alloc, pool.wm_demote) == \
            pool.config.frames(96)


# --------------------------------------------------------------------- #
# TierSan fleet law: corruption injection
# --------------------------------------------------------------------- #
class TestFleetSan:
    def test_clean_fleet_passes(self):
        fleet = small_fleet()
        fleet.run(32)
        check_fleet_conservation(fleet.coordinator)

    def test_detects_budget_leak(self):
        fleet = small_fleet()
        fleet.pools[0].budget += 4  # mint frames outside the coordinator
        with pytest.raises(TierSanError, match="fleet-conservation"):
            check_fleet_conservation(fleet.coordinator)
        with pytest.raises(AssertionError, match="fleet budget leak"):
            fleet.coordinator.check_conservation()

    def test_detects_silent_watermark_bypass(self):
        fleet = small_fleet(budget=120)
        sp = fleet.pools[0]
        # a budget that never reached the watermarks (apply bypassed)
        sp.budget = 50
        fleet.pools[1].budget = 70  # keep the sum conserved
        with pytest.raises(TierSanError, match="fleet-pushdown"):
            check_fleet_conservation(fleet.coordinator)

    def test_detects_stale_control_capacity(self):
        fleet = small_fleet(budget=120)
        fleet.coordinator.push(fleet.coordinator.divide())
        sp = fleet.pools[0]
        sp.control.fast_frames = sp.budget + 5  # quota/watermark drift
        with pytest.raises(TierSanError, match="set_fast_budget"):
            check_fleet_conservation(fleet.coordinator)


# --------------------------------------------------------------------- #
# deterministic per-shard seeding
# --------------------------------------------------------------------- #
class TestDeterminism:
    def test_shard_seeds_are_stable(self):
        fleet = small_fleet()
        assert fleet.shard_seed(0, 0) == 7
        assert fleet.shard_seed(1, 0) == 1007
        assert fleet.shard_seed(3, 1) == 3008

    def test_greedy_and_coordinated_replay_identical_arrivals(self):
        """Mode must change budgets only — never the workload."""
        fleets = [small_fleet(mode=m) for m in ("greedy", "coordinated")]
        for h in range(2):
            traces = [
                make_trace(WORKLOAD, seed=f.shard_seed(h, 0), total_pages=500)
                for f in fleets
            ]
            for _ in range(6):
                a, b = next(traces[0]), next(traces[1])
                assert a.allocs == b.allocs
                assert a.accesses == b.accesses
                assert a.frees == b.frees

    def test_same_seed_same_fleet_result(self):
        runs = [small_fleet(mode="coordinated").run(32) for _ in range(2)]
        assert fleet_view(runs[0]) == fleet_view(runs[1])


# --------------------------------------------------------------------- #
# telemetry windows
# --------------------------------------------------------------------- #
class TestTelemetry:
    def test_windows_diff_not_accumulate(self):
        windows = []
        for pkg in ("torch", "jax"):
            fleet = small_fleet(mode="greedy", pkg=pkg)
            sp = fleet.pools[0]
            sp.sim.run(16)
            first = sp.telemetry()
            sp.sim.run(16)
            second = sp.telemetry()
            assert first.accesses > 0 and second.accesses > 0
            # a window is one period, not the cumulative total
            assert second.accesses < first.accesses + second.accesses
            assert first.measured >= 1.0
            assert set(first.per_class) == set(CLASSES)
            windows.append((dataclasses.asdict(first), dataclasses.asdict(second)))
        assert windows[0] == windows[1]

    def test_ledger_free_shard_reports_on_target(self):
        from repro_torch.core.engine import VectorPagePool

        sp = ShardPool(host=0, name="bare", pool=VectorPagePool(64, 64))
        t = sp.telemetry()
        assert (t.accesses, t.measured, t.pressure) == (0, 1.0, 1.0)


# --------------------------------------------------------------------- #
# the benchmark
# --------------------------------------------------------------------- #
def test_fleet_bench_quick_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # nothing may land in the working directory
    out = tmp_path / "fleet.json"
    lines = fleet_bench.run(quick=True, out=str(out))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["fleet.json"]
    import json

    got = json.loads(out.read_text())["results"]
    for mode in ("greedy", "coordinated"):
        fleet, res = jax_fleet_bench._run(mode, jax_fleet_bench.QUICK_STEPS,
                                          jax_fleet_bench.QUICK_MEASURE_FROM, "vectorized")
        assert got[mode]["coordinator_timeline"] == res.coordinator["timeline"]
        want = json.loads(json.dumps(res.summary()))
        assert {k: got[mode][k] for k in want} == want
        assert f"fleet/{mode}_lc_slowdown,0.0,x{res.lc_slowdown:.3f}" in lines
    assert lines[-1].startswith("fleet/lc_improvement,0.0,")


# --------------------------------------------------------------------- #
# the gloo mesh
# --------------------------------------------------------------------- #
class TestMesh:
    def test_mesh_reduction_matches_numpy(self):
        request_host_devices(4)
        n = host_device_count()
        assert n >= 2
        rows = np.arange(12, dtype=np.float64).reshape(min(n, 4), -1) + 0.5
        got = mesh_reduce_telemetry(rows)
        assert got is not None and got.dtype == np.float64
        np.testing.assert_array_equal(got, rows.sum(axis=0))
        # fewer rows than ranks: zero rows pad the spare ranks
        np.testing.assert_array_equal(mesh_reduce_telemetry(rows[:1]), rows[0])
        np.testing.assert_array_equal(mesh_reduce_telemetry(np.asarray([1.5, 2.0])),
                                      np.asarray([3.5]))
        with pytest.raises(ValueError, match="n_hosts"):
            mesh_reduce_telemetry(np.zeros((0, 3)))
        # a running group keeps its size
        assert request_host_devices(n) is True
        assert request_host_devices(n + 1) is False
        assert host_device_count() == n

    def test_oversubscribed_mesh_falls_back(self):
        rows = np.ones((host_device_count() + 1, 2))
        assert mesh_reduce_telemetry(rows) is None

    def test_mesh_backed_coordinator_equals_numpy(self):
        request_host_devices(4)
        res = {}
        for use_mesh in (True, False):
            fleet = small_fleet(budget=120,
                                coordinator=FleetCoordinatorConfig(use_mesh=use_mesh))
            res[use_mesh] = fleet.run(32)
            check_fleet_conservation(fleet.coordinator)
        for entry in res[True].coordinator["timeline"]:
            assert np.isfinite(entry["fleet_pressure"])
        assert res[True].coordinator == res[False].coordinator


# --------------------------------------------------------------------- #
# serving pools as fleet shards
# --------------------------------------------------------------------- #
class TestServingShards:
    def test_expert_tier_joins_a_fleet(self):
        from repro.qos import QosArbiter as JaxQosArbiter
        from repro.serving.expert_tier import ExpertTierConfig as JaxExpertTierConfig
        from repro.serving.expert_tier import ExpertTierManager as JaxExpertTierManager
        from repro_torch.qos import QosArbiter
        from repro_torch.serving.expert_tier import ExpertTierConfig, ExpertTierManager

        L, E = 2, 8
        weights = {"wi": np.random.default_rng(0).standard_normal((L, E, 4, 8))
                   .astype(np.float32)}
        out = {}
        for pkg in ("torch", "jax"):
            tpp = TppConfig(demote_budget=4, promote_budget=4)
            if pkg == "torch":
                mgr = ExpertTierManager(
                    ExpertTierConfig(n_layers=L, n_experts=E, fast_capacity=12, tpp=tpp),
                    weights, control=QosArbiter(2, 12), tenant_of_expert=lambda l, e: l,
                    device="cpu")
                coord_cls, cfg_cls, check = (FleetCoordinator, FleetCoordinatorConfig,
                                             check_fleet_conservation)
            else:
                from repro.core import TppConfig as JaxTppConfig

                mgr = JaxExpertTierManager(
                    JaxExpertTierConfig(n_layers=L, n_experts=E, fast_capacity=12,
                                        tpp=JaxTppConfig(demote_budget=4, promote_budget=4)),
                    weights, control=JaxQosArbiter(2, 12),
                    tenant_of_expert=lambda l, e: l)
                coord_cls, cfg_cls, check = (jfleet.FleetCoordinator,
                                             jfleet.FleetCoordinatorConfig, jax_check_fleet)
            shard = mgr.as_shard_pool(host=0)
            assert shard.key == "h0/experts"
            assert shard.physical_fast == 12
            assert shard.slow_cost == mgr.cfg.slow_cost
            coord = coord_cls([shard], global_budget=8, config=cfg_cls(min_budget=4))
            coord.push(coord.initial_budgets())
            assert mgr.pool.fast_budget == 8
            assert mgr.pool.control.fast_frames == 8
            check(coord)
            # traffic still flows under the shrunken budget
            rng = np.random.default_rng(0)
            for step in range(16):
                hits = [(l, int(np.minimum(rng.zipf(1.6), E)) - 1) for l in range(L)]
                for (l, e) in hits:
                    mgr.lookup(l, e)
                mgr.step(hits)
                if step % 4 == 3:
                    mgr.pool.end_interval()
            check(coord)
            out[pkg] = (mgr.pool.vmstat.as_dict(), mgr.placement().tolist(),
                        mgr.hbm_hits, mgr.host_hits, dataclasses.asdict(shard.telemetry()))
        assert out["torch"] == out["jax"]

    def test_kv_engine_exposes_shard_adapter(self):
        from repro_torch.configs import get_smoke_config
        from repro_torch.models.model import init_params
        from repro_torch.serving import EngineConfig, ServingEngine

        cfg = get_smoke_config("tinyllama-1.1b")
        params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        eng = ServingEngine(cfg, params, EngineConfig(
            page_size=4, num_fast=32, num_slow=32, topk_pages=None,
            qos=QosConfig(),
        ), device="cpu")
        shard = eng.as_shard_pool(host=3)
        assert shard.key == "h3/kv"
        assert shard.control is eng.control
        assert shard.pool is eng.kv.pool and shard.traffic is None
        coord = FleetCoordinator([shard], global_budget=16)
        coord.push(coord.initial_budgets())
        assert eng.kv.pool.fast_budget == 16
        check_fleet_conservation(coord)
        rid = eng.add_request(list(range(8)), max_new=2)
        for _ in range(2):
            eng.step()
        assert rid in eng.requests
        check_fleet_conservation(coord)


# --------------------------------------------------------------------- #
# chip_smoke.py's serving fleet, on the CPU, against the JAX package
# --------------------------------------------------------------------- #
GLOBAL_BUDGET = 24  # of the two engines' 32 fast frames
CHUNK = 16  # generate steps a host between coordinator ticks
HOST_KINDS = ("bursty", "poisson")  # host 0 MMPP, host 1 Poisson
RELIEF = "shed"  # "control" never drains at the greedy 12 frames (ROADMAP Queue 3)


def drained(sched):
    return not (sched.queue or sched.slots.occupied() or sched._next < len(sched.trace))


def serving_fleet(scheds, mode, fleet_mod, check):
    """The fleet phase's loop (``FleetSimulator.run``'s, over traffic
    shards): push the greedy split; then ``HostShard.step(CHUNK)`` on
    each host and, when coordinated, one ``tick()`` between rounds, until
    both schedulers drain.  Returns what the phase compares."""
    hosts = [fleet_mod.HostShard(h, [s.engine.as_shard_pool(host=h, traffic=s)])
             for h, s in enumerate(scheds)]
    coord = fleet_mod.FleetCoordinator([h.pools[0] for h in hosts], GLOBAL_BUDGET,
                                       fleet_mod.FleetCoordinatorConfig(use_mesh=True))
    coord.push(coord.initial_budgets())
    check(coord)
    while True:
        for h in hosts:
            h.step(CHUNK)
        if all(drained(s) for s in scheds):
            break
        if mode == "coordinated":
            coord.tick()
            check(coord)
    for s in scheds:
        s.engine.kv.pool.check_invariants()
    return (coord.summary(),
            [(s.result().summary(), s.completed, s.engine.stats()) for s in scheds])


@pytest.fixture(scope="module")
def smoke_models():
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.model import init_params as jax_init_params
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import params_from_jax

    jcfg = jax_smoke_config("tinyllama-1.1b")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_smoke_config("tinyllama-1.1b"), tparams


@pytest.mark.parametrize("mode", ["greedy", "coordinated"])
def test_serving_fleet_matches_jax(smoke_models, mode, monkeypatch):
    from repro.serving import ServingEngine as JaxServingEngine
    from repro.traffic import TrafficConfig as JaxTrafficConfig
    from repro.traffic import TrafficScheduler as JaxTrafficScheduler
    from repro.traffic import generate_trace as jax_generate_trace

    jcfg, jparams, tcfg, tparams = smoke_models
    ecfg = dataclasses.replace(traffic_bench.ENGINE_CONFIG, topk_pages=None)
    request_host_devices(2)
    mesh_calls = []
    plain_reduce = coordinator_mod.mesh_reduce_telemetry

    def recording(rows):
        got = plain_reduce(rows)
        mesh_calls.append((np.array(rows), got))
        return got

    monkeypatch.setattr(coordinator_mod, "mesh_reduce_telemetry", recording)
    port = serving_fleet(
        [traffic_bench.scheduler(tcfg, tparams, traffic_bench.trace(k, tcfg.vocab), RELIEF,
                                 ecfg, device="cpu") for k in HOST_KINDS],
        mode, tfleet, check_fleet_conservation)

    jecfg = dataclasses.replace(jax_traffic_bench._engine(jcfg, jparams).ecfg, topk_pages=None)
    jscheds = [JaxTrafficScheduler(
        JaxServingEngine(jcfg, jparams, jecfg, seed=0),
        jax_generate_trace(jax_traffic_bench._arrivals(k), seed=jax_traffic_bench.SEED,
                           vocab=jcfg.vocab, max_requests=jax_traffic_bench.N_REQUESTS),
        JaxTrafficConfig(relief=RELIEF, pause_steps=4, evict_backoff_steps=10))
        for k in HOST_KINDS]
    ref = serving_fleet(jscheds, mode, jfleet, jax_check_fleet)

    assert port[0] == ref[0]  # budgets, shares, pressures, fleet pressure
    for (ps, pc, pstats), (js, jc, jstats) in zip(port[1], ref[1]):
        assert ps == js
        assert pc == jc
        assert pstats == jstats
        assert len(pc) == jax_traffic_bench.N_REQUESTS
    timeline = port[0]["timeline"]
    if mode == "greedy":
        assert timeline == [] and not mesh_calls
    else:
        # the coordinator re-divided: some tick left the greedy 12/12 split
        assert any(e["budgets"] != [12, 12] for e in timeline)
        assert len(mesh_calls) == len(timeline) > 0
        for rows, got in mesh_calls:
            assert got is not None
            np.testing.assert_array_equal(got, rows.sum(axis=0))
