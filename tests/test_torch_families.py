"""The five model families the JAX ``ServingEngine`` pages beside
tinyllama-1.1b and phi3.5-moe: gemma3-4b (5:1 sliding window, GeGLU,
tied embeddings, two stacks), phi3-medium-14b (G=4), chatglm3-6b
(rope2d, qkv bias), qwen2-vl-2b (M-RoPE, the vision stub's
``patch_proj``) and musicgen-medium (MHA, GELU with bias, a vocab×4
codebook table).

For all ten archs, each port config equals its JAX counterpart field
for field and the port's ``init_params`` builds the JAX tree (names,
shapes, dtypes, bytes) at full width; both engines refuse zamba2-2.7b
and xlstm-350m with the same words; and the port's batched engine equals the JAX batched engine
over the lifecycle of ``tests/test_serving_parity.py`` on the smoke
configs, with JAX weights converted by ``params_from_jax``, in float32
on the CPU.  Every field must be equal, not close.  The reference-plane
cases are in ``test_torch_families_reference.py``.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import TppConfig as JaxTppConfig  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from test_serving_parity import lifecycle_trace as jax_lifecycle_trace  # noqa: E402
from test_torch_models import _flatten  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    get_config,
    get_smoke_config,
    list_archs,
    served_archs,
)
from repro_torch.core import TppConfig  # noqa: E402
from repro_torch.launch.serve import lifecycle_trace  # noqa: E402
from repro_torch.models.model import init_params, param_bytes, params_from_jax  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402

FAMILIES = ("gemma3-4b", "phi3-medium-14b", "chatglm3-6b", "qwen2-vl-2b",
            "musicgen-medium")
SERVED = ("tinyllama-1.1b",) + FAMILIES + ("phi3.5-moe-42b-a6.6b",)
# decoded through decode_step; the engines refuse MLA, the SSM and the hybrid
RECURRENT = ("zamba2-2.7b", "xlstm-350m")
ARCHS = SERVED + ("deepseek-v2-lite-16b",) + RECURRENT
# tests/test_serving_parity.py:37-40
BASE = dict(page_size=4, num_fast=10, num_slow=64, recent_pages=1)
FIELDS = ("tokens", "stats", "finished_out", "tiers", "types", "vmstat")


def test_the_port_registers_every_arch_the_jax_engine_serves():
    """All ten archs of the JAX package; the engine's seven among them."""
    assert sorted(list_archs()) == sorted(ARCHS)
    assert sorted(served_archs()) == sorted(SERVED)


@pytest.mark.parametrize("size", ["config", "smoke_config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax(arch, size):
    get = {"config": (get_config, jax_config),
           "smoke_config": (get_smoke_config, jax_smoke_config)}[size]
    got, want = get[0](arch), get[1](arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_layers == want.n_layers and got.max_window() == want.max_window()


@pytest.mark.parametrize("arch", RECURRENT)
def test_the_engine_refuses_ssm_and_hybrid_as_jax_does(arch):
    """Both engines refuse a config with a recurrent mixer, with JAX's
    words (the port's message drops JAX's "v1" and its DESIGN.md pointer)."""
    jcfg = jax_smoke_config(arch)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(ValueError, match="pages GQA attention archs; SSM/hybrid"):
        JaxServingEngine(jcfg, jp, JaxEngineConfig())
    with pytest.raises(ValueError, match="pages GQA attention archs; SSM/hybrid"):
        ServingEngine(get_smoke_config(arch), params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu"), EngineConfig(),
            device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_params_match_jax_tree_and_bytes(arch):
    """On ``meta`` at the published widths, against ``jax.eval_shape``:
    nothing is drawn or allocated on either side."""
    jcfg = jax_config(arch)
    shapes = jax.eval_shape(lambda key: jax_init_params(key, jcfg),
                            jax.random.PRNGKey(0))
    jflat = _flatten(shapes)
    tflat = _flatten(init_params(get_config(arch), torch.Generator(), device="meta"))
    assert sorted(jflat) == sorted(tflat)
    for path, want in jflat.items():
        got = tflat[path]
        if want is None:
            assert got is None, path
            continue
        assert tuple(got.shape) == tuple(want.shape), path
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), path
    want_bytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                     for x in jax.tree_util.tree_leaves(shapes))
    assert param_bytes(get_config(arch)) == want_bytes


@functools.lru_cache(maxsize=None)
def models(arch):
    cfg = jax_smoke_config(arch)
    params = jax_init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                        device="cpu")


@functools.lru_cache(maxsize=None)
def port_trace(arch):
    """The lifecycle on the port's batched plane, top-2 pages."""
    _, _, tparams = models(arch)
    cfg = get_smoke_config(arch)
    eng = ServingEngine(cfg, tparams, EngineConfig(
        data_plane="batched", topk_pages=2,
        tpp=TppConfig(demote_budget=16, promote_budget=8), **BASE),
        seed=0, device="cpu")
    return lifecycle_trace(eng, cfg.vocab)


@pytest.mark.parametrize("arch", FAMILIES)
def test_batched_lifecycle_matches_jax_batched_engine(arch):
    jcfg, jparams, _ = models(arch)
    want = jax_lifecycle_trace(jcfg, jparams, JaxEngineConfig(
        data_plane="batched", topk_pages=2,
        tpp=JaxTppConfig(demote_budget=16, promote_budget=8), **BASE))
    got = port_trace(arch)
    assert want["stats"][-1]["demoted"] > 0, "the trace must exercise tiering"
    for field in FIELDS:
        assert got[field] == want[field], field


def test_musicgen_tokens_span_the_codebook_table():
    """The greedy argmax runs over ``vocab × n_codebooks`` logits, as in
    the JAX engine: the lifecycle emits ids past one codebook's vocab."""
    cfg = get_smoke_config("musicgen-medium")
    got = port_trace("musicgen-medium")
    toks = [t for step in got["tokens"] for t in step.values()]
    assert max(toks) >= cfg.vocab
    assert all(0 <= t < cfg.vocab * cfg.n_codebooks for t in toks)


@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_serves_each_family_on_the_cpu(monkeypatch, capsys, arch):
    from repro_torch.launch import serve as launcher

    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--smoke", "--device",
                                     "cpu", "--requests", "2", "--prompt-len", "9",
                                     "--max-new", "4", "--page-size", "4",
                                     "--num-fast", "4"])
    launcher.main()
    out = capsys.readouterr().out
    assert "8 tokens in 4 steps on cpu" in out
    assert "policy=tpp data_plane=batched " in out
