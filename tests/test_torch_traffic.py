"""The port's traffic front end on its own: arrivals, slot lifecycle,
relief, determinism — the tests of ``tests/test_traffic.py`` over
``repro_torch.traffic`` and the port's ``ServingEngine`` on the CPU.

Weights are the JAX package's ``init_params(PRNGKey(0))`` of the smoke
config, converted by ``params_from_jax``; the cross-framework checks
(traces, summaries and tokens equal to the JAX scheduler's) are in
``tests/test_torch_traffic_reference.py``.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import Tier, TppConfig  # noqa: E402
from repro_torch.core.control import VictimCandidate  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402
from repro_torch.qos import QosConfig, make_control  # noqa: E402
from repro_torch.serving import AdmissionError, EngineConfig, ServingEngine  # noqa: E402
from repro_torch.traffic import (  # noqa: E402
    BurstyArrivals,
    ClassMix,
    PoissonArrivals,
    RequestSpec,
    SlotEngine,
    SlotError,
    TrafficConfig,
    TrafficScheduler,
    generate_trace,
)

CLASSES = ("latency_critical", "standard", "batch")


@pytest.fixture(scope="module")
def tiny():
    jparams = jax_init_params(jax.random.PRNGKey(0), jax_smoke_config("tinyllama-1.1b"))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return get_smoke_config("tinyllama-1.1b"), params


def make_engine(tiny, qos=True, data_plane="reference", num_fast=24,
                max_seqs=4, **kw):
    """tests/test_traffic.py's engine (the reference plane by default)."""
    cfg, params = tiny
    return cfg, ServingEngine(cfg, params, EngineConfig(
        page_size=4, num_fast=num_fast, num_slow=128, topk_pages=None,
        max_seqs=max_seqs, data_plane=data_plane,
        tpp=TppConfig(demote_budget=16, promote_budget=8),
        qos=QosConfig(classes=CLASSES) if qos else None, **kw,
    ), device="cpu")


# --------------------------------------------------------------------- #
# arrival processes: seed determinism, bounds, engine-agnosticism
# --------------------------------------------------------------------- #
class TestArrivals:
    def test_poisson_trace_is_seed_reproducible(self):
        a = generate_trace(PoissonArrivals(30.0), seed=11, vocab=100,
                           max_requests=40)
        b = generate_trace(PoissonArrivals(30.0), seed=11, vocab=100,
                           max_requests=40)
        assert a == b  # full structural equality, prompts included
        c = generate_trace(PoissonArrivals(30.0), seed=12, vocab=100,
                           max_requests=40)
        assert a != c

    def test_bursty_trace_is_seed_reproducible(self):
        proc = BurstyArrivals(60.0, mean_burst=1.0, mean_idle=2.0)
        a = generate_trace(proc, seed=5, vocab=64, horizon=8.0)
        b = generate_trace(proc, seed=5, vocab=64, horizon=8.0)
        assert a == b and len(a) > 0

    def test_traces_are_time_ordered_and_bounded(self):
        tr = generate_trace(PoissonArrivals(50.0), seed=2, vocab=64,
                            horizon=4.0, max_requests=100)
        assert all(tr[i].t <= tr[i + 1].t for i in range(len(tr) - 1))
        assert all(r.t <= 4.0 for r in tr) and len(tr) <= 100
        assert [r.index for r in tr] == list(range(len(tr)))

    def test_bursty_clusters_more_than_poisson(self):
        """Equal offered load, but the MMPP's interarrival CV is higher."""
        bursty = BurstyArrivals(80.0, mean_burst=1.0, mean_idle=3.0)
        assert bursty.mean_rate == pytest.approx(20.0)
        tb = generate_trace(bursty, seed=3, vocab=64, horizon=60.0)
        tp = generate_trace(PoissonArrivals(20.0), seed=3, vocab=64,
                            horizon=60.0)

        def cv(trace):
            gaps = np.diff([r.t for r in trace])
            return gaps.std() / gaps.mean()

        assert cv(tb) > cv(tp) > 0.5  # Poisson CV ~ 1, MMPP > 1

    def test_generator_validation(self):
        with pytest.raises(ValueError, match="rate"):
            PoissonArrivals(0.0)
        with pytest.raises(ValueError, match="burst_rate"):
            BurstyArrivals(-1.0)
        with pytest.raises(ValueError, match="bound"):
            generate_trace(PoissonArrivals(1.0), seed=0, vocab=10)
        with pytest.raises(ValueError, match="weight"):
            generate_trace(
                PoissonArrivals(1.0), seed=0, vocab=10, horizon=1.0,
                mix=(ClassMix("standard", 0, 0.0),))

    def test_trace_is_engine_agnostic_pure_data(self):
        """A trace is immutable data with no engine reference at all."""
        tr = generate_trace(PoissonArrivals(10.0), seed=1, vocab=32,
                            max_requests=3)
        with pytest.raises(dataclasses.FrozenInstanceError):
            tr[0].t = 0.0


# --------------------------------------------------------------------- #
# slot lifecycle under the full sanitizer
# --------------------------------------------------------------------- #
class TestSlotLifecycle:
    @pytest.mark.parametrize("data_plane", ["reference", "batched"])
    def test_randomized_lifecycle_leaks_nothing(self, tiny, monkeypatch, data_plane):
        """Property test: random prefill/insert/generate/evict/refill
        churn under TIERSAN_LEVEL=full frees every frame it touched, on
        either plane (the batched one flushes through the copy kernels'
        plain versions)."""
        monkeypatch.setenv("TIERSAN_LEVEL", "full")
        cfg, eng = make_engine(tiny, num_fast=16, data_plane=data_plane)
        free0 = (eng.kv.pool.free_frames(Tier.FAST),
                 eng.kv.pool.free_frames(Tier.SLOW))
        slots = SlotEngine(eng)
        rng = np.random.default_rng(42)
        inserted = 0
        for _ in range(60):
            op = rng.integers(0, 10)
            free = slots.free_slots()
            occ = slots.occupied()
            if op < 4 and free:
                prompt = list(rng.integers(0, cfg.vocab,
                                           int(rng.integers(4, 12))))
                qos = CLASSES[int(rng.integers(0, 3))]
                try:
                    rid = slots.prefill(prompt, max_new=int(
                        rng.integers(2, 6)), qos_class=qos,
                        tenant=int(rng.integers(0, 3)))
                except AdmissionError:
                    continue
                slots.insert(rid, int(rng.choice(free)))
                inserted += 1
            elif op < 8 and occ:
                for slot, (_, done) in slots.generate().items():
                    if done:
                        slots.release(slot)
            elif op == 8 and occ:
                slots.evict(int(rng.choice([s.slot for s in occ])))
            elif occ:
                s = occ[int(rng.integers(0, len(occ)))]
                if s.paused:
                    slots.resume(s.slot)
                else:
                    slots.pause(s.slot)
        assert inserted > 10  # the walk actually exercised admission
        assert eng.kv.pool.tiersan.checks > 0
        for s in list(slots.occupied()):
            slots.release(s.slot)
        assert not slots.occupied() and not eng.seqs
        assert (eng.kv.pool.free_frames(Tier.FAST),
                eng.kv.pool.free_frames(Tier.SLOW)) == free0
        eng.kv.pool.check_invariants()

    def test_double_insert_and_occupied_lane_raise(self, tiny, monkeypatch):
        monkeypatch.setenv("TIERSAN_LEVEL", "full")
        cfg, eng = make_engine(tiny)
        slots = SlotEngine(eng)
        r1 = slots.prefill([1, 2, 3], max_new=2)
        r2 = slots.prefill([4, 5, 6], max_new=2)
        slots.insert(r1, 0)
        with pytest.raises(SlotError, match="already holds"):
            slots.insert(r2, 0)  # occupied lane
        with pytest.raises(SlotError, match="already inserted"):
            slots.insert(r1, 1)  # double-insert of the same rid
        with pytest.raises(SlotError, match="outside"):
            slots.insert(r2, 99)
        slots.insert(r2, 1)
        with pytest.raises(ValueError, match="already inserted"):
            eng.insert_request(r1)  # engine-level double attach

    def test_release_and_pause_errors(self, tiny):
        cfg, eng = make_engine(tiny, qos=False)
        slots = SlotEngine(eng)
        with pytest.raises(SlotError, match="not occupied"):
            slots.release(0)
        rid = slots.prefill([1, 2, 3, 4], max_new=2)
        slots.insert(rid, 2)
        with pytest.raises(SlotError, match="not paused"):
            slots.resume(2)
        slots.pause(2)
        with pytest.raises(SlotError, match="already paused"):
            slots.pause(2)
        slots.resume(2)
        slots.release(2)
        assert slots.free_slots() == [0, 1, 2, 3]

    @pytest.mark.parametrize("data_plane", ["reference", "batched"])
    def test_detached_prefill_holds_kv_but_skips_decode(self, tiny, data_plane):
        """A detached prefill runs ``flash_attention`` once a layer and
        no decode kernel until it is inserted."""
        cfg, eng = make_engine(tiny, qos=False, data_plane=data_plane)
        calls = []
        flash = kernel_ops.flash_attention

        def counted(*args, **kwargs):
            calls.append(1)
            return flash(*args, **kwargs)

        kernel_ops.flash_attention = counted
        try:
            rid = eng.prefill_request([1, 2, 3, 4, 5], max_new=3)
        finally:
            kernel_ops.flash_attention = flash
        assert len(calls) == cfg.n_layers
        assert eng.seqs[rid].detached and eng.seqs[rid].pages
        assert eng.step() == {}  # detached => not decoded
        eng.insert_request(rid)
        assert rid in eng.step()

    def test_queue_overflow_is_admission_error(self, tiny):
        cfg, eng = make_engine(tiny, qos=False)
        tr = generate_trace(PoissonArrivals(10.0), seed=0, vocab=cfg.vocab,
                            max_requests=4)
        sched = TrafficScheduler(eng, tr, TrafficConfig(queue_cap=2,
                                                        relief="none"))
        sched.offer(tr[0])
        sched.offer(tr[1])
        with pytest.raises(AdmissionError, match="queue_cap") as ei:
            sched.offer(tr[2])
        assert ei.value.reason == "queue_full"


# --------------------------------------------------------------------- #
# control-plane relief: escalation + victim ordering
# --------------------------------------------------------------------- #
class _FakePool:
    """Minimal pool surface for arbiter relief unit tests."""

    wm_demote = 4

    def __init__(self, free=2):
        self.free = free
        self.pages = {}  # pid -> (tier, active)

    def free_frames(self, tier):
        return self.free

    def has_page(self, pid):
        return pid in self.pages

    def tier_of(self, pid):
        return self.pages[pid][0]

    def is_active(self, pid):
        return self.pages[pid][1]


class TestRelief:
    def make_arbiter(self, **kw):
        qc = QosConfig(classes=CLASSES, **kw)
        return make_control(qc, n_tenants=3, fast_frames=100)

    def test_relief_escalates_shed_to_evict_and_resets(self):
        arb = self.make_arbiter(evict_after=3)
        pool = _FakePool(free=2)  # free <= wm_demote: pressured
        arb.fast_pages = arb.quota.astype(np.int64) + 10  # all over quota
        # evictions are paced: the streak resets after each "evict" so
        # victims are spaced evict_after pressured queries apart
        assert [arb.relief_action(pool) for _ in range(6)] == \
            ["shed", "shed", "evict", "shed", "shed", "evict"]
        assert arb.evictions_recommended == 2
        pool.free = 50  # pressure clears => streak resets
        assert arb.relief_action(pool) == "none"
        pool.free = 2
        assert arb.relief_action(pool) == "shed"
        assert arb.qos_summary()["evictions_recommended"] == 2

    def test_no_pressure_without_overquota_tenant(self):
        arb = self.make_arbiter()
        pool = _FakePool(free=2)
        arb.fast_pages = np.zeros(3, np.int64)  # nobody over quota
        assert arb.relief_action(pool) == "none"

    def test_victims_order_lowest_share_coldest_first(self):
        arb = self.make_arbiter()
        pool = _FakePool()
        # tenant 0 (LC, largest quota) hot+fast; tenant 2 (batch,
        # smallest quota) cold+slow
        pool.pages = {
            1: (Tier.FAST, True), 2: (Tier.FAST, True),
            3: (Tier.SLOW, False), 4: (Tier.SLOW, False),
        }
        lc = VictimCandidate(key=0, tenant=0, pids=(1, 2),
                             qos_class="latency_critical")
        batch = VictimCandidate(key=1, tenant=2, pids=(3, 4),
                                qos_class="batch")
        ordered = arb.order_pressure_victims([lc, batch], pool)
        assert [v.key for v in ordered] == [1, 0]
        # deterministic tiebreak on equal scores: lane key order
        b2 = VictimCandidate(key=5, tenant=2, pids=(3, 4),
                             qos_class="batch")
        ordered = arb.order_pressure_victims([b2, batch, lc], pool)
        assert [v.key for v in ordered] == [1, 5, 0]
        assert arb.order_pressure_victims([], pool) == []

    def test_scheduler_evicts_batch_and_pauses_lc(self, tiny, monkeypatch):
        cfg, eng = make_engine(tiny)
        specs = (
            RequestSpec(0, 0.0, 0, "latency_critical",
                        tuple(range(1, 7)), 6),
            RequestSpec(1, 0.0, 2, "batch", tuple(range(10, 18)), 8),
        )
        sched = TrafficScheduler(eng, specs, TrafficConfig(
            relief="control", max_victims=2, pause_steps=2))
        sched.step_once()  # both admitted and decoding
        assert len(sched.slots.occupied()) == 2
        monkeypatch.setattr(eng.control, "relief_action",
                            lambda pool: "evict")
        monkeypatch.setattr(eng.control, "shed_batch_request",
                            lambda pool: True)  # pressure blocks re-admit
        sched.step_once()
        assert sched.evictions == 1 and sched.pauses == 1
        # the batch request restarted from the queue front, and the
        # post-evict hold keeps it there instead of re-filling the lane
        # it vacated (no thrash)
        assert [s.index for s in sched.queue] == [1]
        assert sched._batch_hold > 0
        rec = sched.records[1]
        assert rec.first_token is None and not rec.token_times
        # the LC lane is paused, resumes after pause_steps
        lc_slot = sched.slots.slot_of(sched.slots.occupied()[0].rid)
        assert sched.slots.lanes[lc_slot].paused
        monkeypatch.setattr(eng.control, "relief_action",
                            lambda pool: "none")
        monkeypatch.setattr(eng.control, "shed_batch_request",
                            lambda pool: False)
        sched.step_once()
        sched.step_once()
        assert not sched.slots.lanes[lc_slot].paused
        res = sched.run()
        assert sched.records[1].attempts == 2  # evicted then re-admitted
        per = {c: m for c, m in res.per_class.items()}
        assert per["batch"].evicted == 1 and per["batch"].completed == 1
        assert per["latency_critical"].paused == 1
        # TTFT of the evicted request still counts from ORIGINAL arrival
        assert sched.records[1].ttft > sched.records[0].ttft


# --------------------------------------------------------------------- #
# scheduler end-to-end + determinism
# --------------------------------------------------------------------- #
class TestScheduler:
    @pytest.mark.parametrize("data_plane", ["reference", "batched"])
    def test_poisson_end_to_end_accounts_every_arrival(self, tiny, data_plane):
        cfg, eng = make_engine(tiny, data_plane=data_plane)
        tr = generate_trace(PoissonArrivals(50.0), seed=9, vocab=cfg.vocab,
                            max_requests=16)
        sched = TrafficScheduler(eng, tr, TrafficConfig(relief="control"))
        res = sched.run()
        arrived = sum(m.arrived for m in res.per_class.values())
        done = sum(m.completed for m in res.per_class.values())
        dropped = sum(m.dropped for m in res.per_class.values())
        assert arrived == 16 and done + dropped == 16
        assert not sched.slots.occupied() and not eng.seqs
        for idx, toks in sched.completed.items():
            assert len(toks) == tr[idx].max_new  # ran to max_new
        for m in res.per_class.values():
            assert m.slo_met <= m.completed
            assert all(t > 0 for t in m.ttft)
        assert res.horizon_ms >= tr[-1].t * 1e3
        eng.kv.pool.check_invariants()

    def test_same_seed_same_run(self, tiny):
        summaries = []
        for _ in range(2):
            cfg, eng = make_engine(tiny)
            tr = generate_trace(PoissonArrivals(60.0), seed=4,
                                vocab=cfg.vocab, max_requests=10)
            sched = TrafficScheduler(eng, tr,
                                     TrafficConfig(relief="control"))
            summaries.append((sched.run().summary(), sched.completed))
        assert summaries[0] == summaries[1]

    def test_same_trace_same_tokens_on_both_planes(self, tiny):
        """Engine-agnostic traces: the reference and batched data planes
        serve one trace to identical tokens and identical clocks."""
        runs = {}
        for plane in ("reference", "batched"):
            cfg, eng = make_engine(tiny, qos=False, data_plane=plane)
            tr = generate_trace(PoissonArrivals(40.0), seed=8,
                                vocab=cfg.vocab, max_requests=8)
            sched = TrafficScheduler(eng, tr, TrafficConfig(relief="none"))
            res = sched.run()
            runs[plane] = (sched.completed, res.summary())
        assert runs["reference"][0] == runs["batched"][0]
        assert runs["reference"][1] == runs["batched"][1]
