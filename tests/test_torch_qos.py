"""The port's multi-tenant QoS control plane against ``repro.qos``.

``make_control`` builds the same control from a static ``QosConfig``, a
dynamic three-class one and a ``SlowdownControllerConfig`` in both
packages.  Each is attached to a ``PagePool`` of its package, and one
seeded script of tenant-tagged allocations, touches (fed to the control
as ``note_hits``, as the serving engine does), frees and TPP steps
drives both.  After every interval ``qos_summary()``, quotas, shares,
promotion tokens, VmStat (``pgpromote_fail_qos`` and
``pgalloc_steered`` among its counters), the shed signal and the relief
verdict must be equal.
"""

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.qos as jqos  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.qos as tqos  # noqa: E402

CLASSES3 = ("latency_critical", "standard", "batch")

SPECS = {
    "static": lambda q: q.QosConfig(mode="static", shares=(0.9, 0.1)),
    "dynamic-3-class": lambda q: q.QosConfig(mode="dynamic", classes=CLASSES3,
                                             promote_tokens_per_interval=6),
    "slowdown-controller": lambda q: q.SlowdownControllerConfig(
        gain=0.5, qos=q.QosConfig(classes=CLASSES3)),
}


def drive(core, qos, spec, seed, intervals=12):
    """One package's pool under ``make_control(spec)``; yields what the
    control shows after each interval."""
    n_tenants = 2 if spec == "static" else 3
    pool = core.PagePool(24, 64, config=core.TppConfig(demote_budget=8, promote_budget=8))
    control = qos.make_control(SPECS[spec](qos), n_tenants=n_tenants, fast_frames=24)
    assert isinstance(control, qos.SlowdownController
                      if spec == "slowdown-controller" else qos.QosArbiter)
    pool.control = control
    if spec == "static":
        control.configure_tenant(0, "latency_critical")
        control.configure_tenant(1, "batch")
    policy = core.make_policy("tpp", pool, seed=seed)
    rng = np.random.default_rng(seed)
    live = []
    for _ in range(intervals):
        for _ in range(4):
            for _ in range(rng.integers(0, 4)):
                tenant = int(rng.integers(0, n_tenants))
                live.append(pool.allocate(core.PageType(int(rng.integers(0, 2))),
                                          tenant=tenant).pid)
            if live and rng.random() < 0.4:
                pool.free(live.pop(int(rng.integers(0, len(live)))))
            hot = [live[i] for i in rng.choice(len(live), size=min(len(live), 14),
                                               replace=False)] if live else []
            slow, fast = [], []
            for pid in hot:
                (slow if pool.touch(pid) == core.Tier.SLOW else fast).append(pid)
            control.note_hits(np.asarray(fast, np.int64), np.asarray(slow, np.int64))
            policy.step(slow, fast)
        pool.end_interval()
        pool.check_invariants()
        control.check_consistency(pool)
        yield {
            "summary": control.qos_summary(),
            "quota": control.quota.tolist(),
            "tokens": control.tokens.tolist(),
            "shares": getattr(control, "shares", np.zeros(0)).tolist(),
            "vmstat": pool.vmstat.as_dict(),
            "shed": control.shed_batch_request(pool),
            "relief": control.relief_action(pool),
            "tiers": {pid: int(p.tier) for pid, p in pool.pages.items()},
        }


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("seed", [0, 3])
def test_control_matches_repro_qos(spec, seed):
    n = 0
    seen = {"shed": False, "denied": False}
    for want, got in zip(drive(jcore, jqos, spec, seed), drive(tcore, tqos, spec, seed)):
        for key in want:
            assert got[key] == want[key], (n, key)
        seen["shed"] |= want["shed"]
        seen["denied"] |= want["vmstat"]["pgpromote_fail_qos"] > 0
        n += 1
    assert n == 12
    vm = want["vmstat"]
    assert vm["pgdemote_total"] > 0 and vm["pgpromote_total"] > 0
    assert vm["pgalloc_steered"] > 0
    assert seen["shed"] and seen["denied"], seen


def test_make_control_passes_a_ready_control_and_refuses_others():
    ready = tqos.TenantAccounting(2)
    assert tqos.make_control(ready, n_tenants=2, fast_frames=8) is ready
    for qos in (jqos, tqos):
        with pytest.raises(TypeError, match="qos spec must be"):
            qos.make_control("static", n_tenants=1, fast_frames=8)
    assert sorted(tqos.__all__) == sorted(jqos.__all__)
