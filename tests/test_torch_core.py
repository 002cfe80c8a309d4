"""The port's copy of the placement engine against ``repro.core``.

One seeded script of allocate / touch / end_interval / free, driven
through ``repro.core.PagePool`` and a policy (``TppPolicy`` or one of
the paper's baselines: ``linux``, ``numa_balancing``, ``autotiering``,
``ideal``) and through the port's copies: VmStat, the tier of every
page and the order of every LRU list must be equal after every
interval.
"""

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402


def snapshot(pool):
    lru = {
        (int(tier), int(pt), active): list(pool.lru[tier].list_for(pt, active)._d)
        for tier in (pool.lru.keys())
        for pt in (0, 1)
        for active in (False, True)
    }
    tiers = {pid: (int(p.tier), p.frame, int(p.page_type), int(p.flags))
             for pid, p in pool.pages.items()}
    return pool.vmstat.as_dict(), tiers, lru


def drive(core, seed, intervals, tpp_kw, policy="tpp", frames=(24, 64)):
    """Run the script on one package's core; yields a snapshot per interval."""
    pool = core.PagePool(*frames, config=core.TppConfig(**tpp_kw))
    policy = core.make_policy(policy, pool, seed=seed)
    rng = np.random.default_rng(seed)
    live = []
    for _ in range(intervals):
        for _ in range(4):  # steps per interval
            for _ in range(rng.integers(0, 4)):
                ptype = core.PageType(int(rng.integers(0, 2)))
                live.append(pool.allocate(ptype, tenant=int(rng.integers(0, 3))).pid)
            if live and rng.random() < 0.3:
                pool.free(live.pop(int(rng.integers(0, len(live)))))
            hot = [live[i] for i in rng.choice(len(live), size=min(len(live), 12),
                                               replace=False)] if live else []
            slow, fast = [], []
            for pid in hot:
                (slow if pool.touch(pid) == core.Tier.SLOW else fast).append(pid)
            policy.step(slow, fast)
        pool.end_interval()
        pool.check_invariants()
        yield snapshot(pool)


@pytest.mark.parametrize("seed,tpp_kw", [
    (0, {}),
    (1, dict(demote_budget=8, promote_budget=4)),
    (2, dict(file_to_slow=True, sample_rate=0.5)),
    (3, dict(decoupled=False, active_lru_filter=False)),
])
def test_tpp_script_matches_repro_core(seed, tpp_kw):
    n = 0
    for want, got in zip(drive(jcore, seed, 12, tpp_kw), drive(tcore, seed, 12, tpp_kw)):
        assert got[0] == want[0], "vmstat"
        assert got[1] == want[1], "page tiers"
        assert got[2] == want[2], "LRU order"
        n += 1
    assert n == 12
    assert want[0]["pgdemote_total"] > 0 and want[0]["pgpromote_sampled"] > 0


# what each baseline must show on the script, so that it is exercised
def _linux(vm):
    return vm["pgdemote_total"] == vm["pgpromote_total"] == 0 and vm["access_slow"] > 0


def _numa(vm):
    return vm["pgdemote_total"] == 0 and vm["pgpromote_total"] > 0


def _autotiering(vm):
    return vm["pgdemote_total"] > 0 and vm["pgpromote_total"] > 0


def _ideal(vm):
    return vm["access_slow"] == 0 and vm["pgalloc_slow"] == 0 and vm["access_fast"] > 0


@pytest.mark.parametrize("policy,seed,tpp_kw,frames,exercised", [
    ("linux", 0, {}, (24, 64), _linux),
    ("linux", 1, dict(file_to_slow=True), (16, 64), _linux),
    ("numa_balancing", 0, {}, (24, 64), _numa),
    ("numa_balancing", 2, dict(sample_rate=0.5), (32, 64), _numa),
    ("autotiering", 0, {}, (24, 64), _autotiering),
    ("autotiering", 3, dict(demote_budget=4), (16, 64), _autotiering),
    ("ideal", 0, {}, (256, 0), _ideal),
    ("ideal", 4, dict(file_to_slow=True), (160, 0), _ideal),
])
def test_baseline_script_matches_repro_core(policy, seed, tpp_kw, frames, exercised):
    n = 0
    for want, got in zip(drive(jcore, seed, 12, tpp_kw, policy, frames),
                         drive(tcore, seed, 12, tpp_kw, policy, frames)):
        assert got[0] == want[0], "vmstat"
        assert got[1] == want[1], "page tiers"
        assert got[2] == want[2], "LRU order"
        n += 1
    assert n == 12
    assert exercised(want[0]), want[0]


def test_make_policy_registers_every_jax_policy():
    """The port's registry holds the JAX package's policies, no more and no
    fewer; ``ideal`` refuses a pool with a slow tier, as in JAX."""
    jcore.make_policy("tpp", jcore.PagePool(8, 8))
    tcore.make_policy("tpp", tcore.PagePool(8, 8))
    assert sorted(tcore.POLICY_REGISTRY) == sorted(jcore.POLICY_REGISTRY)
    for core in (jcore, tcore):
        with pytest.raises(ValueError, match="num_slow=0"):
            core.make_policy("ideal", core.PagePool(8, 8))
        with pytest.raises(ValueError, match="unknown policy"):
            core.make_policy("nope", core.PagePool(8, 8))
