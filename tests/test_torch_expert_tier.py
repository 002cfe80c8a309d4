"""The port's expert tier against the JAX package's, on the CPU.

``ExpertTierManager`` keeps a device bank and a host bank of expert
weights under the port's ``PagePool`` and policies.  On the stream of
``benchmarks/expert_tiering.py`` (zipf(1.5) routing, an interval tick
every 4 steps) its counts, ``placement()`` and VmStat must equal the JAX
manager's for both of the benchmark's geometries and all three
policies, and every expert's payload must survive the migrations bit for
bit.  The tests of ``tests/test_serving.py``'s ``TestExpertTiering`` run
on the port as well.
"""

import functools
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from benchmarks import expert_tiering as jax_bench  # noqa: E402
from repro.core import TppConfig as JaxTppConfig  # noqa: E402
from repro.serving.expert_tier import ExpertTierConfig as JaxExpertTierConfig  # noqa: E402
from repro.serving.expert_tier import ExpertTierManager as JaxExpertTierManager  # noqa: E402
from repro_torch.benchmarks import expert_tiering as bench  # noqa: E402
from repro_torch.core import Tier, TppConfig  # noqa: E402
from repro_torch.qos import TenantAccounting  # noqa: E402
from repro_torch.serving.expert_tier import ExpertTierConfig, ExpertTierManager  # noqa: E402

STEPS = 120  # the benchmark's quick stream
CASES = [pytest.param(case, policy, id=f"{case[0]}-{policy}")
         for case in bench.CASES for policy in bench.POLICIES]


def weights(L, E, seed=0):
    rng = np.random.default_rng(seed)
    return {"wi_gate": rng.standard_normal((L, E, 8, 16)).astype(np.float32),
            "wo": rng.standard_normal((L, E, 16, 8)).astype(np.float32)}


def counts(mgr):
    return {"hbm_hits": mgr.hbm_hits, "host_hits": mgr.host_hits, "steps": mgr.steps,
            "fast_fraction": mgr.fast_fraction(), "modeled_cost": mgr.modeled_cost(),
            "placement": mgr.placement().tolist(), "vmstat": mgr.pool.vmstat.as_dict()}


@functools.lru_cache(maxsize=None)
def jax_counts(name, L, E, K, frac, policy):
    mgr = JaxExpertTierManager(
        JaxExpertTierConfig(n_layers=L, n_experts=E, fast_capacity=int(frac * L * E),
                            policy=policy,
                            tpp=JaxTppConfig(demote_budget=16, promote_budget=16)),
        weights(L, E), seed=1)
    bench.drive(mgr, K, STEPS)  # duck-typed: the same stream over either manager
    mgr.pool.check_invariants()
    return counts(mgr)


@pytest.mark.parametrize("case,policy", CASES)
def test_benchmark_stream_matches_jax(case, policy):
    name, L, E, K, frac = case
    w = weights(L, E)
    mgr = bench.manager(L, E, frac, policy, w, device="cpu")
    bench.drive(mgr, K, STEPS)
    mgr.pool.check_invariants()
    got = counts(mgr)
    assert got == jax_counts(*case, policy)
    moved = got["vmstat"]["pgpromote_total"] + got["vmstat"]["pgdemote_total"]
    assert (moved == 0) == (policy == "linux")
    # every expert's rows, wherever it lives after the migrations
    for (l, e), pid in mgr.pid_of.items():
        rows, tier = mgr.lookup(l, e)
        assert tier == mgr.pool.pages[pid].tier
        for k, v in rows.items():
            assert torch.equal(v, torch.from_numpy(w[k][l, e])), (l, e, k)


def test_phi35_counts_are_the_recorded_ones():
    """The phi3.5 geometry's counts at 120 steps (``ExpertTierManager``
    with 51 fast experts), as the chip run holds them."""
    got = {}
    for policy in bench.POLICIES:
        mgr = bench.manager(8, 16, 0.4, policy, weights(8, 16), device="cpu")
        bench.drive(mgr, 2, STEPS)
        vm = mgr.pool.vmstat
        got[policy] = (round(mgr.fast_fraction(), 3), mgr.modeled_cost(),
                       vm.pgpromote_total, vm.pgdemote_total)
    assert mgr.cfg.fast_capacity == 51
    assert got == {"linux": (0.0, 15360.0, 0, 0), "autotiering": (0.804, 4559.0, 207, 158),
                   "tpp": (0.765, 5084.0, 205, 157)}


def test_bench_rows_match_jax_but_timing():
    strip = functools.partial(re.sub, r"^([^,]*),[^,]*,", r"\1,")
    got = bench.run(quick=True, device="cpu")
    want = jax_bench.run(quick=True)
    assert [strip(r) for r in got] == [strip(r) for r in want]
    assert len(got) == len(bench.CASES) * len(bench.POLICIES)


def test_banks_are_where_they_belong():
    """The fast bank is ``(fast_capacity, ...)`` on the manager's device,
    the slow bank ``(L·E, ...)`` on the host, a copy of the caller's
    arrays, with expert ``(l, e)`` at row ``l·E + e`` until it moves."""
    L, E = 2, 8
    w = weights(L, E, seed=3)
    mgr = ExpertTierManager(ExpertTierConfig(n_layers=L, n_experts=E, fast_capacity=5),
                            w, device="cpu")
    for k, v in w.items():
        assert mgr.fast_bank[k].shape == (5,) + v.shape[2:]
        assert mgr.fast_bank[k].device == mgr.device
        assert mgr.slow_bank[k].shape == (L * E,) + v.shape[2:]
        assert mgr.slow_bank[k].device.type == "cpu"
        assert torch.equal(mgr.slow_bank[k], torch.from_numpy(v.reshape(L * E, *v.shape[2:])))
        assert mgr.slow_bank[k].data_ptr() != torch.from_numpy(v).data_ptr()
    # tensors are taken as well as arrays
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    mgr2 = ExpertTierManager(ExpertTierConfig(n_layers=L, n_experts=E, fast_capacity=5),
                             tw, device="cpu")
    assert all(torch.equal(mgr2.slow_bank[k], mgr.slow_bank[k]) for k in w)
    assert all(mgr2.slow_bank[k].data_ptr() != tw[k].data_ptr() for k in w)
    for (l, e), pid in mgr.pid_of.items():
        assert mgr.pool.pages[pid].frame == l * E + e


def test_migrations_leave_the_callers_weights_alone():
    """Tensors and broadcast views are copied like arrays: the stream's
    migrations rewrite bank rows only, and a stride-0 view (how a caller
    gives a bank it fills itself) becomes rows that move on their own."""
    L, E, K = 2, 8, 2
    w = {k: torch.from_numpy(v) for k, v in weights(L, E, seed=5).items()}
    before = {k: v.clone() for k, v in w.items()}
    mgr = bench.manager(L, E, 0.4, "tpp", w, device="cpu")
    bench.drive(mgr, K, 40)
    assert mgr.pool.vmstat.pgpromote_total > 0 and mgr.pool.vmstat.pgdemote_total > 0
    assert all(torch.equal(w[k], before[k]) for k in w)
    zeros = {k: torch.zeros(v.shape[2:]).expand(v.shape) for k, v in w.items()}
    mgr = bench.manager(L, E, 0.4, "tpp", zeros, device="cpu")
    for k, v in w.items():
        mgr.slow_bank[k].copy_(v.reshape(L * E, *v.shape[2:]))
        assert not torch.any(zeros[k])
    bench.drive(mgr, K, 40)
    for (l, e), pid in mgr.pid_of.items():
        page = mgr.pool.pages[pid]
        bank = mgr.fast_bank if page.tier == Tier.FAST else mgr.slow_bank
        assert all(torch.equal(bank[k][page.frame], w[k][l, e]) for k in w)


def test_cuda_manager_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExpertTierManager(ExpertTierConfig(n_layers=2, n_experts=4, fast_capacity=4),
                          weights(2, 4))


# --------------------------------------------------------------------- #
# tests/test_serving.py's TestExpertTiering, on the port
# --------------------------------------------------------------------- #
class TestExpertTiering:
    def test_tpp_beats_no_tiering(self):
        L, E = 2, 8
        rng = np.random.default_rng(0)
        weights = {"wi": rng.standard_normal((L, E, 4, 8)).astype(np.float32)}

        def run(policy):
            mgr = ExpertTierManager(
                ExpertTierConfig(n_layers=L, n_experts=E, fast_capacity=6,
                                 policy=policy,
                                 tpp=TppConfig(demote_budget=4, promote_budget=4)),
                weights, device="cpu")
            for step in range(120):
                hits = []
                for l in range(L):
                    r = np.minimum(rng.zipf(1.6, size=2), E) - 1
                    hits += [(l, int(x)) for x in r]
                for (l, e) in hits:
                    mgr.lookup(l, e)
                mgr.step(hits)
            return mgr

        m_tpp = run("tpp")
        m_static = run("linux")
        assert m_tpp.fast_fraction() > m_static.fast_fraction() + 0.3
        # payload integrity after many migrations
        w, _ = m_tpp.lookup(0, 3)
        np.testing.assert_array_equal(w["wi"].numpy(), weights["wi"][0, 3])
        m_tpp.pool.check_invariants()

    def test_expert_frames_attributed_to_tenants(self):
        """Shared-expert frames land in the per-tenant ledger: residency
        follows migrations and hotness accrues per tenant."""
        L, E = 2, 8
        rng = np.random.default_rng(1)
        weights = {"wi": rng.standard_normal((L, E, 4, 8)).astype(np.float32)}
        acc = TenantAccounting(2)
        mgr = ExpertTierManager(
            ExpertTierConfig(n_layers=L, n_experts=E, fast_capacity=6,
                             tpp=TppConfig(demote_budget=4, promote_budget=4)),
            weights,
            control=acc,
            tenant_of_expert=lambda l, e: l,  # layer 0 -> tenant 0, 1 -> 1
            device="cpu",
        )
        assert mgr.pool.control is acc
        acc.check_consistency(mgr.pool)
        assert list(acc.slow_pages) == [E, E]  # all experts start slow
        for step in range(60):
            hits = []
            for l in range(L):
                r = np.minimum(rng.zipf(1.6, size=2), E) - 1
                hits += [(l, int(x)) for x in r]
            for (l, e) in hits:
                mgr.lookup(l, e)
            mgr.step(hits)
            if step % 4 == 3:  # interval ticks stay with the caller
                mgr.pool.end_interval()
        acc.check_consistency(mgr.pool)
        placement = mgr.placement()
        assert list(acc.fast_pages) == [int(placement[0].sum()),
                                        int(placement[1].sum())]
        assert int(acc.promoted_total.sum()) == \
            mgr.pool.vmstat.pgpromote_total
        assert int(acc.access_interval.sum() + acc.hot_ewma.sum()) > 0
        assert acc.intervals > 0  # interval ticks flowed from the pool
        assert sum(1 for p in mgr.pool.pages.values() if p.tier == Tier.FAST) == \
            int(placement.sum())
