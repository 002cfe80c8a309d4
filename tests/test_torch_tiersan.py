"""The port's TierSan and migration-plan check against ``repro.analysis``.

* ``TIERSAN_LEVEL=full`` on the port's pool audits every interval of a
  TPP script (and of one with a QoS arbiter's ledger) and stays quiet,
  as the JAX pool does.
* A pool broken by hand (a frame double-booked, a VmStat counter off by
  one, a counter gone backwards, an LRU list missing a page, a tenant
  ledger drifted) raises ``TierSanError`` in the port with the same
  message as in JAX.
* With ``TIERSAN_PLAN_CHECK=1`` every flush of a serving lifecycle is
  checked, and the port's ``kv.last_plan`` equals the JAX cache's.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.analysis as janalysis  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.qos as jqos  # noqa: E402
import repro_torch.analysis as tanalysis  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.qos as tqos  # noqa: E402

SIDES = {"jax": (jcore, jqos, janalysis), "torch": (tcore, tqos, tanalysis)}


def small_pool(core, qos=None):
    """Ten pages, four touched, one interval closed; with ``qos``, two
    tenants under a static arbiter."""
    pool = core.PagePool(16, 16)
    if qos is not None:
        pool.control = qos.make_control(qos.QosConfig(mode="static", shares=(0.5, 0.5)),
                                        n_tenants=2, fast_frames=16)
    pids = [pool.allocate(core.PageType.ANON, tenant=i % 2).pid for i in range(10)]
    for pid in pids[:4]:
        pool.touch(pid)
    pool.end_interval()
    return pool, pids


def fast_pids(core, pool, pids):
    return [p for p in pids if pool.tier_of(p) == core.Tier.FAST]


# each corruption: (name, needs qos, full audit, break(core, pool, pids))
def _double_book(core, pool, pids):
    a, b = fast_pids(core, pool, pids)[:2]
    pool.pages[b].frame = pool.pages[a].frame


def _free_push(core, pool, pids):
    pool._free[core.Tier.FAST].append(pool.pages[fast_pids(core, pool, pids)[0]].frame)


def _counter_off_by_one(core, pool, pids):
    pool.vmstat.pgfree += 1


def _lru_drop(core, pool, pids):
    victim = fast_pids(core, pool, pids)[0]
    pool.lru[core.Tier.FAST].discard(victim, pool.pages[victim].page_type)


def _ledger_gross(core, pool, pids):
    pool.control.fast_pages[0] += 10_000


def _ledger_small(core, pool, pids):
    pool.control.fast_pages[0] -= 1


CORRUPTIONS = [
    ("frame-double-booked", False, True, _double_book),
    ("free-frame-pushed-twice", False, False, _free_push),
    ("vmstat-counter-off-by-one", False, False, _counter_off_by_one),
    ("lru-page-dropped", False, True, _lru_drop),
    ("ledger-gross-drift", True, False, _ledger_gross),
    ("ledger-drift-of-one", True, True, _ledger_small),
]


def broken_message(side, qos, full, corrupt):
    core, qmod, analysis = SIDES[side]
    pool, pids = small_pool(core, qmod if qos else None)
    san = analysis.TierSan("full" if full else "conservation")
    san.check(pool, full=full)  # clean before the corruption
    corrupt(core, pool, pids)
    with pytest.raises(analysis.TierSanError) as exc:
        san.check(pool, full=full)
    return str(exc.value)


@pytest.mark.parametrize("qos,full,corrupt", [c[1:] for c in CORRUPTIONS],
                         ids=[c[0] for c in CORRUPTIONS])
def test_broken_pool_raises_as_in_jax(qos, full, corrupt):
    want = broken_message("jax", qos, full, corrupt)
    got = broken_message("torch", qos, full, corrupt)
    assert got == want
    assert "violation(s)" in got and "hint:" in got


def test_conservation_misses_a_double_booked_frame_as_in_jax():
    """All counts still balance: only the full audit sees it, on both."""
    for side in SIDES:
        core, _, analysis = SIDES[side]
        pool, pids = small_pool(core)
        _double_book(core, pool, pids)
        analysis.TierSan("conservation").check(pool)
        with pytest.raises(analysis.TierSanError, match="double-mapped"):
            analysis.TierSan("full").check(pool, full=True)


@pytest.mark.parametrize("qos", [False, True], ids=["tpp", "tpp+qos"])
def test_full_level_from_env_audits_every_interval(monkeypatch, qos):
    """The pool picks its sanitizer up from the environment at
    construction and checks at every interval close; a clean script
    passes every check on both packages, and the laws see the same
    counters."""
    monkeypatch.setenv("TIERSAN_LEVEL", "full")
    monkeypatch.delenv("TIERSAN_EVERY", raising=False)
    checks = {}
    for side in SIDES:
        core, qmod, _ = SIDES[side]
        pool = core.PagePool(24, 64, config=core.TppConfig())
        assert pool.tiersan is not None and pool.tiersan.level == "full"
        if qos:
            pool.control = qmod.make_control(
                qmod.QosConfig(mode="dynamic",
                               classes=("latency_critical", "standard", "batch")),
                n_tenants=3, fast_frames=24)
        policy = core.make_policy("tpp", pool, seed=0)
        rng = np.random.default_rng(0)
        live = []
        for _ in range(10):
            for _ in range(4):
                for _ in range(rng.integers(0, 4)):
                    live.append(pool.allocate(core.PageType(int(rng.integers(0, 2))),
                                              tenant=int(rng.integers(0, 3))).pid)
                hot = list(rng.choice(live, size=min(len(live), 12), replace=False))
                slow = [p for p in hot if pool.touch(int(p)) == core.Tier.SLOW]
                policy.step([int(p) for p in slow],
                            [int(p) for p in hot if int(p) not in slow])
            pool.end_interval()
        checks[side] = (pool.tiersan.checks, pool.tiersan.intervals,
                        pool.vmstat.as_dict())
    assert checks["torch"] == checks["jax"]
    assert checks["torch"][0] == 10 and checks["torch"][2]["pgdemote_total"] > 0


def test_env_attached_sanitizer_raises_at_interval_close(monkeypatch):
    monkeypatch.setenv("TIERSAN_LEVEL", "conservation")
    monkeypatch.setenv("TIERSAN_EVERY", "2")
    msgs = {}
    for side in SIDES:
        core, _, analysis = SIDES[side]
        pool, _ = small_pool(core)
        assert pool.tiersan.every == 2
        pool.end_interval()  # interval 2: checked, clean
        assert pool.tiersan.checks == 1
        pool.vmstat.pgfree += 5
        pool.end_interval()  # 3: skipped
        with pytest.raises(analysis.TierSanError) as exc:
            pool.end_interval()  # 4: checked
        msgs[side] = str(exc.value)
    assert msgs["torch"] == msgs["jax"]


@pytest.mark.parametrize("level", ["off", "0", ""])
def test_sanitizer_off_attaches_nothing(level):
    assert tanalysis.tiersan_from_env({"TIERSAN_LEVEL": level}) is None
    assert janalysis.tiersan_from_env({"TIERSAN_LEVEL": level}) is None


def test_diff_engines_across_packages():
    """``diff_engines`` is duck-typed: a JAX pool and the port's pool after
    the same script agree, and a broken counter shows in the same words
    through either package's copy."""
    pools = {}
    for side in SIDES:
        core = SIDES[side][0]
        pool = core.PagePool(24, 64)
        policy = core.make_policy("autotiering", pool, seed=0)
        rng = np.random.default_rng(2)
        live = [pool.allocate(core.PageType.ANON).pid for _ in range(40)]
        for _ in range(8):
            hot = [int(p) for p in rng.choice(live, size=10, replace=False)]
            slow = [p for p in hot if pool.touch(p) == core.Tier.SLOW]
            policy.step(slow, [p for p in hot if p not in slow])
            pool.end_interval()
        pools[side] = pool
    for analysis in (janalysis, tanalysis):
        assert analysis.diff_engines(pools["jax"], pools["torch"]) == {}
    pools["torch"].vmstat.pgpromote_success_anon += 1
    want = janalysis.diff_engines(pools["jax"], pools["torch"])
    assert tanalysis.diff_engines(pools["jax"], pools["torch"]) == want
    assert list(want) == ["vmstat"]


def _swap_plan(analysis):
    """A demotion into the slow frame a promotion frees, and that promotion
    into the fast frame the demotion freed."""
    return [analysis.CopyOp(pid=1, src=2, dst=9, demote=True),
            analysis.CopyOp(pid=2, src=9, dst=2, demote=False)]


@pytest.mark.parametrize("staging", ["gathers-first", "sequential"])
def test_plan_hazards_as_in_jax(staging):
    got = [dataclasses.astuple(h) for h in tanalysis.verify_plan(
        _swap_plan(tanalysis), num_frames=12, trash_frame=11, staging=staging)]
    want = [dataclasses.astuple(h) for h in janalysis.verify_plan(
        _swap_plan(janalysis), num_frames=12, trash_frame=11, staging=staging)]
    assert got == want
    assert bool(got) == (staging == "sequential")
    bad = _swap_plan(tanalysis) + [tanalysis.CopyOp(pid=3, src=11, dst=12)]
    with pytest.raises(tanalysis.PlanHazardError, match="trash-misuse") as exc:
        tanalysis.check_plan(bad, num_frames=12, trash_frame=11, staging=staging)
    with pytest.raises(janalysis.PlanHazardError) as jexc:
        janalysis.check_plan(
            _swap_plan(janalysis) + [janalysis.CopyOp(pid=3, src=11, dst=12)],
            num_frames=12, trash_frame=11, staging=staging)
    assert str(exc.value) == str(jexc.value)


def test_plan_check_last_plan_matches_jax(monkeypatch):
    """The batched lifecycle under ``TIERSAN_PLAN_CHECK=1`` and
    ``TIERSAN_LEVEL=full``: every flush is verified, every interval
    audited, and the last staged plan equals the JAX cache's."""
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.model import init_params as jax_init_params
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving import ServingEngine as JaxServingEngine
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import lifecycle_trace
    from repro_torch.models.model import params_from_jax
    from repro_torch.serving import EngineConfig, ServingEngine

    monkeypatch.setenv("TIERSAN_PLAN_CHECK", "1")
    monkeypatch.setenv("TIERSAN_LEVEL", "full")
    arch = "tinyllama-1.1b"
    jcfg = jax_smoke_config(arch)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    kw = dict(page_size=4, num_fast=10, num_slow=64, recent_pages=1, topk_pages=2,
              data_plane="batched")
    # the port's lifecycle script is duck-typed: it drives the JAX engine too
    jeng = JaxServingEngine(jcfg, jparams, JaxEngineConfig(
        tpp=jcore.TppConfig(demote_budget=16, promote_budget=8), **kw), seed=0)
    want = lifecycle_trace(jeng, jcfg.vocab)
    cfg = get_smoke_config(arch)
    eng = ServingEngine(cfg, tparams, EngineConfig(
        tpp=tcore.TppConfig(demote_budget=16, promote_budget=8), **kw), device="cpu")
    got = lifecycle_trace(eng, cfg.vocab)
    assert got == want
    jkv, tkv = jeng.kv, eng.kv
    assert tkv.plan_check and jkv.plan_check
    assert tkv.pool.tiersan.level == "full" and tkv.pool.tiersan.checks > 0
    assert tkv.pool.tiersan.checks == jkv.pool.tiersan.checks
    assert tkv.last_plan and tkv.flushes > 0
    assert ([dataclasses.astuple(op) for op in tkv.last_plan]
            == [dataclasses.astuple(op) for op in jkv.last_plan])
