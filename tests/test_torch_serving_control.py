"""The port's serving engine under the paper's baselines, the QoS control
plane and the admission rules, against the JAX engine.

* ``linux``, ``numa_balancing``, ``autotiering`` and ``ideal`` drive the
  same migration machinery as TPP: the port's batched plane equals the
  JAX batched engine on tokens and ``stats()`` (the port of
  ``test_batched_policy_baselines``, ``tests/test_serving_parity.py``),
  and the port's reference plane equals its batched plane.
* With ``EngineConfig.qos`` armed, batch-class requests are shed under
  fast-tier pressure and the opt-out restores admission, with the same
  outcome and ``stats()["qos"]`` as the JAX engine (the port of
  ``tests/test_serving.py``'s two QoS engine tests).
* The plane-parametrised admission and resume tests of
  ``tests/test_serving.py``, and the launcher's ``--policy`` and
  ``--data-plane``.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import TppConfig as JaxTppConfig  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.qos import QosConfig as JaxQosConfig  # noqa: E402
from repro.serving import AdmissionError as JaxAdmissionError  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import PageType, TppConfig  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402
from repro_torch.qos import QosConfig  # noqa: E402
from repro_torch.serving import AdmissionError, EngineConfig, ServingEngine  # noqa: E402

ARCH = "tinyllama-1.1b"


@functools.lru_cache(maxsize=None)
def models():
    cfg = jax_smoke_config(ARCH)
    params = jax_init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                        device="cpu")


def torch_engine(**kw):
    return ServingEngine(get_smoke_config(ARCH), models()[2], EngineConfig(**kw),
                         seed=0, device="cpu")


def jax_engine(**kw):
    return JaxServingEngine(models()[0], models()[1], JaxEngineConfig(**kw), seed=0)


# ------------------------------------------------------------------ #
# the paper's baselines on the serving path
# ------------------------------------------------------------------ #
POLICIES = {
    # tests/test_serving_parity.py:152-167, with autotiering and ideal
    "linux": dict(num_fast=8, num_slow=32),
    "numa_balancing": dict(num_fast=8, num_slow=32),
    "autotiering": dict(num_fast=8, num_slow=32),
    "ideal": dict(num_fast=16, num_slow=0),
}


def policy_trace(make, policy, **plane):
    eng = make(page_size=4, topk_pages=2, recent_pages=1, policy=policy,
               **POLICIES[policy], **plane)
    rid = eng.add_request(
        list(np.random.default_rng(5).integers(0, models()[0].vocab, 20)),
        max_new=10)
    out = ([eng.step()[rid] for _ in range(10)], eng.stats())
    eng.kv.pool.check_invariants()
    return out


@pytest.mark.parametrize("policy", list(POLICIES))
def test_batched_policy_baselines(policy):
    """Parity is not TPP-specific: each baseline drives the same staged
    migration machinery, and each keeps its own semantics."""
    want = policy_trace(jax_engine, policy, data_plane="batched")
    got = policy_trace(torch_engine, policy, data_plane="batched")
    assert got == want
    assert policy_trace(torch_engine, policy, data_plane="reference") == got
    toks, stats = got
    if policy == "linux":
        assert stats["demoted"] == stats["promoted"] == stats["migrated_bytes"] == 0
        assert stats["slow_used"] > 0
    elif policy == "numa_balancing":
        assert stats["demoted"] == 0
    elif policy == "autotiering":
        assert stats["demoted"] > 0 and stats["promoted"] > 0
    else:
        assert stats["local_fraction"] == 1.0 and stats["slow_used"] == 0


def test_ideal_refuses_an_engine_with_a_slow_tier():
    with pytest.raises(ValueError, match="num_slow=0"):
        torch_engine(page_size=4, num_fast=16, num_slow=8, policy="ideal")


# ------------------------------------------------------------------ #
# QoS: batch-class shedding (tests/test_serving.py:163-224)
# ------------------------------------------------------------------ #
def qos_outcome(make, qos, error, plane=None, admission_control=True):
    """The shedding scenario: a latency-critical tenant and a batch tenant
    fill an 8-frame fast tier; returns what the engine showed."""
    kw = {} if plane is None else dict(data_plane=plane)
    eng = make(page_size=4, num_fast=8, num_slow=64, topk_pages=None, max_seqs=8,
               tpp=(JaxTppConfig if make is jax_engine else TppConfig)(
                   demote_budget=4, promote_budget=2),
               qos=qos(mode="static", shares=(0.9, 0.1)),
               admission_control=admission_control, **kw)
    rng = np.random.default_rng(7)
    vocab = models()[0].vocab
    lc = eng.add_request(list(rng.integers(0, vocab, 30)), max_new=32,
                         qos_class="latency_critical", tenant=0)
    b0 = eng.add_request(list(rng.integers(0, vocab, 20)), max_new=32,
                         qos_class="batch", tenant=1)
    tokens = [eng.step() for _ in range(4)]
    out = {"tokens": tokens, "pressure": eng.control.shed_batch_request(eng.kv.pool)}
    try:
        r = eng.add_request([1, 2, 3], max_new=2, qos_class="batch", tenant=1)
        out["batch_admitted"] = r in eng.seqs
    except error as exc:
        out["shed_reason"] = exc.reason
    out["live_seqs"] = len(eng.seqs)
    # non-batch classes are never shed
    r = eng.add_request([1, 2, 3], max_new=2, qos_class="standard", tenant=2)
    out["standard_admitted"] = r in eng.seqs
    # releasing the noisy tenant's residency re-opens batch admission
    for rid in list(eng.seqs):
        eng.finish(rid)
    out["pressure_after"] = eng.control.shed_batch_request(eng.kv.pool)
    out["reopened"] = eng.add_request([1, 2, 3], max_new=2, qos_class="batch",
                                      tenant=1) in eng.seqs
    assert lc not in eng.seqs and b0 not in eng.seqs
    out["stats"] = eng.stats()
    eng.kv.pool.check_invariants()
    eng.control.check_consistency(eng.kv.pool)
    return out


@functools.lru_cache(maxsize=None)
def jax_qos_outcome(admission_control):
    return qos_outcome(jax_engine, JaxQosConfig, JaxAdmissionError,
                       admission_control=admission_control)


@pytest.mark.parametrize("plane", ["batched", "reference"])
def test_batch_class_shed_under_control_plane_pressure(plane):
    """While the fast tier sits at the reclaim watermark with a tenant
    over quota, a batch-class request is shed (``qos_pressure``) and
    leaves no state behind; a standard one is admitted; freeing the
    residency re-opens admission.  ``stats()["qos"]`` equals the JAX
    engine's (its reference plane, its default)."""
    want = jax_qos_outcome(True)
    got = qos_outcome(torch_engine, QosConfig, AdmissionError, plane)
    assert got == want
    assert got["pressure"] and got["shed_reason"] == "qos_pressure"
    assert got["live_seqs"] == 2 and got["standard_admitted"]
    assert not got["pressure_after"] and got["reopened"]
    assert got["stats"]["qos"]["shed_total"] >= 2


@pytest.mark.parametrize("plane", ["batched", "reference"])
def test_admission_control_opt_out(plane):
    """``admission_control=False`` admits batch-class requests under the
    same pressure."""
    want = jax_qos_outcome(False)
    got = qos_outcome(torch_engine, QosConfig, AdmissionError, plane,
                      admission_control=False)
    assert got == want
    assert got["pressure"] and got["batch_admitted"] and "shed_reason" not in got


def test_qos_lifecycle_matches_jax(monkeypatch):
    """The two-tenant lifecycle ``chip_smoke.py`` holds cuda against cpu,
    here against the JAX engine, under ``TIERSAN_LEVEL=full`` and
    ``TIERSAN_PLAN_CHECK=1``: both planes of the port equal the JAX
    batched engine in every field, ``stats()["qos"]`` and the steps of
    each ``qos_pressure`` shed among them."""
    monkeypatch.setenv("TIERSAN_LEVEL", "full")
    monkeypatch.setenv("TIERSAN_PLAN_CHECK", "1")
    kw = dict(page_size=4, num_fast=8, num_slow=64, topk_pages=None, max_seqs=8)
    want = launcher.qos_lifecycle_trace(jax_engine(
        data_plane="batched", tpp=JaxTppConfig(demote_budget=4, promote_budget=2),
        qos=JaxQosConfig(mode="static", shares=(0.9, 0.1)), **kw), models()[0].vocab)
    assert want["shed_at_steps"] and want["admitted"]
    assert want["vmstat"]["pgdemote_total"] > 0 and want["vmstat"]["pgpromote_total"] > 0
    for plane in ("batched", "reference"):
        eng = torch_engine(data_plane=plane, tpp=TppConfig(demote_budget=4,
                                                           promote_budget=2),
                           qos=QosConfig(mode="static", shares=(0.9, 0.1)), **kw)
        got = launcher.qos_lifecycle_trace(eng, models()[0].vocab)
        assert got == want, plane
        assert eng.kv.pool.tiersan.checks == got["stats"][-1]["steps"] // 4


def test_bad_qos_class_leaves_no_state():
    eng = torch_engine(page_size=4, num_fast=16, num_slow=16,
                       qos=QosConfig(mode="static", shares=(0.5, 0.5)))
    with pytest.raises(ValueError):
        eng.add_request([1, 2, 3], qos_class="platinum")
    assert eng.seqs == {} and eng.requests == {}
    assert "qos" in eng.stats() and "qos" not in torch_engine(
        page_size=4, num_fast=16, num_slow=16).stats()


# ------------------------------------------------------------------ #
# lifecycle on both planes (tests/test_serving.py:101-160)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("plane", ["reference", "batched"])
def test_resume_retypes_tail_anon(plane):
    """pause→resume hands the unsealed tail back to ANON."""
    eng = torch_engine(page_size=4, num_fast=32, num_slow=32, topk_pages=None,
                       data_plane=plane)
    rid = eng.add_request(
        list(np.random.default_rng(4).integers(0, models()[0].vocab, 10)), max_new=12)
    eng.step()
    eng.pause(rid)
    pages = eng.kv.pool.pages
    seq = eng.seqs[rid]
    assert all(pages[p].page_type == PageType.FILE for p in seq.pages)
    eng.resume(rid)
    assert pages[seq.pages[-1]].page_type == PageType.ANON
    assert all(pages[p].page_type == PageType.FILE for p in seq.pages[:-1])
    eng.step()
    assert pages[seq.pages[-1]].page_type == PageType.ANON


@pytest.mark.parametrize("plane", ["reference", "batched"])
def test_max_seqs_admission(plane):
    eng = torch_engine(page_size=4, num_fast=64, num_slow=32, topk_pages=None,
                       max_seqs=2, data_plane=plane)
    r0 = eng.add_request([1, 2, 3], max_new=2)
    eng.add_request([4, 5, 6], max_new=2)
    with pytest.raises(AdmissionError) as exc:
        eng.add_request([7, 8, 9], max_new=2)
    assert exc.value.reason == "max_seqs"
    eng.finish(r0)  # freeing a slot re-opens admission
    r2 = eng.add_request([7, 8, 9], max_new=2)
    assert eng.step()[r2] is not None


def test_finish_releases_request_on_the_reference_plane():
    eng = torch_engine(page_size=4, num_fast=32, num_slow=32, topk_pages=None,
                       data_plane="reference")
    rid = eng.add_request(
        list(np.random.default_rng(5).integers(0, models()[0].vocab, 6)), max_new=3)
    for _ in range(3):
        eng.step()
    req = eng.finish(rid)
    assert req.rid == rid and len(req.out) == 3 and req.done
    assert rid not in eng.requests and rid not in eng.seqs
    for _ in range(3):
        r = eng.add_request([1, 2, 3], max_new=1)
        eng.step()
        eng.finish(r)
    assert len(eng.requests) == 0 and len(eng.seqs) == 0 and eng._summaries == {}
    eng.kv.pool.check_invariants()


def test_unknown_data_plane_is_refused():
    with pytest.raises(ValueError, match="unknown data_plane"):
        torch_engine(data_plane="fused")


# ------------------------------------------------------------------ #
# the launcher
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("argv,policy,plane", [
    (["--policy", "linux"], "linux", "batched"),
    (["--policy", "numa_balancing"], "numa_balancing", "batched"),
    (["--policy", "autotiering", "--data-plane", "reference"], "autotiering",
     "reference"),
    (["--policy", "ideal"], "ideal", "batched"),
    (["--data-plane", "reference"], "tpp", "reference"),
])
def test_launcher_prints_the_policy_that_ran(monkeypatch, capsys, argv, policy, plane):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--smoke", "--device",
                                     "cpu", "--requests", "2", "--prompt-len", "9",
                                     "--max-new", "4", "--page-size", "4",
                                     "--num-fast", "4", *argv])
    launcher.main()
    out = capsys.readouterr().out
    assert f"policy={policy} data_plane={plane} " in out
    if policy == "ideal":
        # 2 × ceil((9 - 1 + 4) / 4) = 6 pages, all fast
        assert "num_slow=0, num_fast=8 (the run's 6 pages" in out
        assert "local=1.000" in out


def test_ideal_fast_tier_holds_every_page_above_the_min_watermark():
    tpp = TppConfig(demote_budget=64, promote_budget=32)
    assert launcher.pages_needed(8, 48, 32, 16) == 40
    n = launcher.ideal_num_fast(40, tpp)
    assert n - 40 > tpp.frames(n)[0] and not (n - 1) - 40 > tpp.frames(n - 1)[0]
