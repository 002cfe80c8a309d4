"""The port's slice as a whole: its batched serving engine against the JAX
package's batched engine on the same weights and the same lifecycle.

Weights come from the JAX ``init_params(PRNGKey(0), smoke_config)``,
converted leaf by leaf through numpy by ``params_from_jax``; the port
runs on ``device="cpu"``, where every kernel wrapper takes its plain
PyTorch version.  Tokens, ``stats()``, VmStat, tiers and page types must
be equal — not close.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import TppConfig as JaxTppConfig  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from test_serving_parity import lifecycle_trace as jax_lifecycle_trace  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import TppConfig  # noqa: E402
from repro_torch.launch.serve import lifecycle_trace  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402
from repro_torch.serving import AdmissionError, EngineConfig, ServingEngine  # noqa: E402

pytestmark = pytest.mark.slow

# tests/test_serving_parity.py:37-40; the JAX side runs that file's own
# lifecycle_trace, the port's side repro_torch.launch.serve.lifecycle_trace
BASE = dict(page_size=4, num_fast=10, num_slow=64, recent_pages=1)


@pytest.fixture(scope="module")
def tiny():
    cfg = jax_smoke_config("tinyllama-1.1b")
    params = jax_init_params(jax.random.PRNGKey(0), cfg)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return cfg, params, params_from_jax(np_params, device="cpu")


@pytest.mark.parametrize("topk", [2, None], ids=["topk", "exact"])
def test_lifecycle_matches_jax_batched_engine(tiny, topk):
    jcfg, jparams, tparams = tiny
    want = jax_lifecycle_trace(jcfg, jparams, JaxEngineConfig(
        data_plane="batched", topk_pages=topk,
        tpp=JaxTppConfig(demote_budget=16, promote_budget=8), **BASE))
    cfg = get_smoke_config("tinyllama-1.1b")
    eng = ServingEngine(cfg, tparams, EngineConfig(
        data_plane="batched", topk_pages=topk,
        tpp=TppConfig(demote_budget=16, promote_budget=8), **BASE),
        seed=0, device="cpu")
    got = lifecycle_trace(eng, cfg.vocab)
    assert want["stats"][-1]["demoted"] > 0, "the trace must exercise tiering"
    for field in ("tokens", "stats", "finished_out", "tiers", "types", "vmstat"):
        assert got[field] == want[field], field


def test_page_key_summaries_match_jax(tiny):
    """Five sequences pad to eight lanes, so three pad lanes add into the
    trash slot in the same step: the page-key sums must accumulate
    duplicate indices as JAX's ``.at[].add`` does, and every real
    sequence's summaries must match."""
    jcfg, jparams, tparams = tiny
    kw = dict(data_plane="batched", topk_pages=2, **BASE)
    engines = {
        "jax": JaxServingEngine(jcfg, jparams, JaxEngineConfig(
            tpp=JaxTppConfig(demote_budget=16, promote_budget=8), **kw), seed=0),
        "torch": ServingEngine(get_smoke_config("tinyllama-1.1b"), tparams,
                               EngineConfig(tpp=TppConfig(demote_budget=16,
                                                          promote_budget=8), **kw),
                               seed=0, device="cpu"),
    }
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(0, jcfg.vocab, n)) for n in (9, 6, 13, 5, 11)]
    out = {}
    for name, eng in engines.items():
        for p in prompts:
            eng.add_request(p, max_new=8)
        out[name] = [eng.step() for _ in range(6)]
    assert out["torch"] == out["jax"]
    jeng, teng = engines["jax"], engines["torch"]
    np.testing.assert_array_equal(teng._kcnt.numpy(), np.asarray(jeng._kcnt))
    np.testing.assert_allclose(teng._ksum.numpy(), np.asarray(jeng._ksum),
                               atol=1e-5, rtol=1e-5)


def test_default_device_is_cuda_and_never_falls_back(tiny, monkeypatch):
    """Built without a ``device`` argument, the engine asks for CUDA; with no
    CUDA it raises instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tparams = tiny
    cfg = get_smoke_config("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg, tparams, EngineConfig(**BASE))


def test_detached_prefill_and_admission_cap(tiny):
    """``prefill_request`` holds a sequence out of the decode batch until
    ``insert_request``; its tokens then equal an ``add_request`` run, and
    admission stops at ``max_seqs``."""
    _, _, tparams = tiny
    cfg = get_smoke_config("tinyllama-1.1b")
    prompt = list(np.random.default_rng(5).integers(0, cfg.vocab, 11))

    def engine():
        return ServingEngine(cfg, tparams, EngineConfig(max_seqs=2, **BASE),
                             device="cpu")

    ref = engine()
    rid = ref.add_request(prompt, max_new=4)
    want = [ref.step()[rid] for _ in range(4)]
    eng = engine()
    rid = eng.prefill_request(prompt, max_new=4)
    assert eng.step() == {} and eng.free_lanes() == 1
    eng.insert_request(rid)
    with pytest.raises(ValueError):
        eng.insert_request(rid)
    assert [eng.step()[rid] for _ in range(4)] == want
    eng.add_request([1, 2, 3])
    with pytest.raises(AdmissionError) as exc:
        eng.add_request([1, 2, 3])
    assert exc.value.reason == "max_seqs"
