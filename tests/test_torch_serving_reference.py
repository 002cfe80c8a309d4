"""The port's reference data plane against the JAX reference plane, and
against the port's own batched plane.

The reference plane decodes one sequence at a time with attention in
plain torch ops, writes each token's KV on its own, keeps its page-key
summaries on the host and copies every migration eagerly; it is the
executable specification the batched plane is held to.  The lifecycle is
the pause/resume/finish trace of ``tests/test_serving_parity.py``, on
the smoke configs with JAX weights converted by ``params_from_jax``, in
float32 on the CPU.  Every field must be equal — not close.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import TppConfig as JaxTppConfig  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from test_serving_parity import lifecycle_trace as jax_lifecycle_trace  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import Tier, TppConfig  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.launch.serve import lifecycle_trace  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402

ARCHS = ("tinyllama-1.1b", "phi3.5-moe-42b-a6.6b")
# tests/test_serving_parity.py:37-40
BASE = dict(page_size=4, num_fast=10, num_slow=64, recent_pages=1)
FIELDS = ("tokens", "stats", "finished_out", "tiers", "types", "vmstat")
CASES = [pytest.param(arch, topk, id=f"{arch}-{'topk' if topk else 'exact'}")
         for arch in ARCHS for topk in (2, None)]


@functools.lru_cache(maxsize=None)
def models(arch):
    cfg = jax_smoke_config(arch)
    params = jax_init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                        device="cpu")


def engine(arch, plane, topk, **kw):
    _, _, tparams = models(arch)
    return ServingEngine(get_smoke_config(arch), tparams, EngineConfig(
        data_plane=plane, topk_pages=topk,
        tpp=TppConfig(demote_budget=16, promote_budget=8), **BASE, **kw),
        seed=0, device="cpu")


@functools.lru_cache(maxsize=None)
def torch_trace(arch, plane, topk):
    """The lifecycle on the port's engine, with the calls it made to each
    kernel wrapper."""
    names = ("paged_attention", "page_gather", "page_scatter", "flash_attention",
             "moe_route")
    calls = dict.fromkeys(names, 0)
    saved = {n: getattr(kernel_ops, n) for n in names}

    def counted(name):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return saved[name](*args, **kwargs)
        return wrapper

    for n in names:
        setattr(kernel_ops, n, counted(n))
    try:
        eng = engine(arch, plane, topk)
        trace = lifecycle_trace(eng, eng.cfg.vocab)
    finally:
        for n, fn in saved.items():
            setattr(kernel_ops, n, fn)
    return trace, calls, eng


@functools.lru_cache(maxsize=None)
def jax_reference_trace(arch, topk):
    jcfg, jparams, _ = models(arch)
    return jax_lifecycle_trace(jcfg, jparams, JaxEngineConfig(
        data_plane="reference", topk_pages=topk,
        tpp=JaxTppConfig(demote_budget=16, promote_budget=8), **BASE))


@pytest.mark.parametrize("arch,topk", CASES)
def test_reference_plane_matches_jax_reference_plane(arch, topk):
    """The MoE cases run ``moe_fwd`` (the fused routing stage's plain
    version) once a layer for every sequence's decode step."""
    want = jax_reference_trace(arch, topk)
    got, calls, eng = torch_trace(arch, "reference", topk)
    assert want["stats"][-1]["demoted"] > 0, "the trace must exercise tiering"
    for field in FIELDS:
        assert got[field] == want[field], field
    # no block table and no staged flush: attention is plain torch ops and
    # every migration copies eagerly
    L = eng.cfg.n_layers
    assert calls["paged_attention"] == calls["page_gather"] == calls["page_scatter"] == 0
    assert calls["flash_attention"] == 3 * L
    assert (calls["moe_route"] > 0) == (arch != "tinyllama-1.1b")
    assert not eng.kv.cfg.staged_migration and eng.kv.flushes == 0
    assert eng.kv.migrated_bytes == got["stats"][-1]["migrated_bytes"] > 0


@pytest.mark.parametrize("arch,topk", CASES)
def test_reference_plane_matches_batched_plane(arch, topk):
    ref, _, _ = torch_trace(arch, "reference", topk)
    bat, calls, eng = torch_trace(arch, "batched", topk)
    for field in FIELDS:
        assert bat[field] == ref[field], field
    assert calls["paged_attention"] > 0 and eng.kv.flushes > 0


def test_single_token_prompt_on_both_planes():
    """Edge: no prefill pages — the first decode writes page 0, and the
    first selection is empty."""
    outs = {}
    for plane in ("reference", "batched"):
        eng = engine("tinyllama-1.1b", plane, 2)
        rid = eng.add_request([5], max_new=6)
        outs[plane] = [eng.step()[rid] for _ in range(6)]
    assert outs["batched"] == outs["reference"]


def test_reference_plane_is_exact_while_pages_migrate():
    """Eager copies never change a result: with exact attention and pages
    demoted and promoted every interval, the tokens equal a run whose
    fast tier holds every page."""
    _, _, tparams = models("tinyllama-1.1b")
    cfg = get_smoke_config("tinyllama-1.1b")
    prompt = list(np.random.default_rng(1).integers(0, cfg.vocab, 24))
    outs = {}
    for num_fast, num_slow in ((8, 32), (64, 8)):
        eng = ServingEngine(cfg, tparams, EngineConfig(
            page_size=4, num_fast=num_fast, num_slow=num_slow, topk_pages=None,
            data_plane="reference", tpp=TppConfig(demote_budget=16, promote_budget=8)),
            device="cpu")
        rid = eng.add_request(prompt, max_new=6)
        outs[num_fast] = [eng.step()[rid] for _ in range(6)]
        eng.kv.pool.check_invariants()
        if num_fast == 8:
            assert eng.kv.pool.used_frames(Tier.SLOW) > 0, "test needs tiering"
            assert eng.kv.migrated_pages > 0
        else:
            assert eng.kv.migrated_pages == 0
    assert outs[8] == outs[64]


def test_reference_summaries_are_host_arrays_equal_to_the_pages_means():
    """The reference plane scores pages on the host, as the JAX engine
    does: each live page's summary is the mean of its written keys."""
    eng = engine("tinyllama-1.1b", "reference", 2)
    rid = eng.add_request(list(range(1, 12)), max_new=5)
    for _ in range(3):
        eng.step()
    seq = eng.seqs[rid]
    assert sorted(eng._summaries) == sorted(seq.pages)
    a = eng.cfg.all_specs()[0].attn
    for i, pid in enumerate(seq.pages):
        written = min(eng.ecfg.page_size, seq.cur_len - i * eng.ecfg.page_size)
        keys = eng._page_keys(pid)
        assert keys.shape == (eng.cfg.n_layers, eng.ecfg.page_size, a.n_kv_heads,
                              a.head_dim)
        # the tail page is averaged over its written slots; sealed pages
        # over all of them
        want = keys[:, :written].mean(axis=1) if i == len(seq.pages) - 1 \
            else keys.mean(axis=1)
        np.testing.assert_array_equal(eng._summaries[pid], want)
    assert not hasattr(eng, "_ksum")
    eng.finish(rid)
    assert eng._summaries == {}
