"""The five families of ``test_torch_families.py`` on the reference data
plane: the port's reference plane against the JAX reference plane over
the lifecycle of ``tests/test_serving_parity.py``, and the port of
``test_lifecycle_parity_windowed``: on gemma3-4b's smoke config (window
8) the port's batched plane, whose ``paged_attention`` masks the window
by position, equals its reference plane and the JAX reference plane.

Smoke configs, JAX weights converted by ``params_from_jax``, float32 on
the CPU.  Every field must be equal, not close.
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
from repro_torch.core import TppConfig  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.launch.serve import lifecycle_trace  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402

FAMILIES = ("gemma3-4b", "phi3-medium-14b", "chatglm3-6b", "qwen2-vl-2b",
            "musicgen-medium")
# tests/test_serving_parity.py:37-40
BASE = dict(page_size=4, num_fast=10, num_slow=64, recent_pages=1)
FIELDS = ("tokens", "stats", "finished_out", "tiers", "types", "vmstat")


@functools.lru_cache(maxsize=None)
def models(arch):
    cfg = jax_smoke_config(arch)
    params = jax_init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                        device="cpu")


@functools.lru_cache(maxsize=None)
def port_trace(arch, plane):
    """The lifecycle on the port's engine, top-2 pages, with the calls it
    made to the attention and copy wrappers."""
    names = ("paged_attention", "page_gather", "page_scatter", "flash_attention")
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
        cfg = get_smoke_config(arch)
        eng = ServingEngine(cfg, models(arch)[2], EngineConfig(
            data_plane=plane, topk_pages=2,
            tpp=TppConfig(demote_budget=16, promote_budget=8), **BASE),
            seed=0, device="cpu")
        trace = lifecycle_trace(eng, cfg.vocab)
    finally:
        for n, fn in saved.items():
            setattr(kernel_ops, n, fn)
    return trace, calls, eng


@functools.lru_cache(maxsize=None)
def jax_reference_trace(arch):
    jcfg, jparams, _ = models(arch)
    return jax_lifecycle_trace(jcfg, jparams, JaxEngineConfig(
        data_plane="reference", topk_pages=2,
        tpp=JaxTppConfig(demote_budget=16, promote_budget=8), **BASE))


@pytest.mark.parametrize("arch", FAMILIES)
def test_reference_plane_matches_jax_reference_plane(arch):
    want = jax_reference_trace(arch)
    got, calls, eng = port_trace(arch, "reference")
    assert want["stats"][-1]["demoted"] > 0, "the trace must exercise tiering"
    for field in FIELDS:
        assert got[field] == want[field], field
    assert calls["paged_attention"] == calls["page_gather"] == calls["page_scatter"] == 0
    assert calls["flash_attention"] == 3 * eng.cfg.n_layers
    assert eng.kv.flushes == 0 and eng.kv.migrated_bytes > 0


def test_lifecycle_parity_windowed():
    """gemma3's local layers (window 8 over pages of 4) mask in
    ``paged_attention`` by absolute position on the batched plane and by
    each cache slot's position on the reference plane; the lifecycle's
    longest sequence (30 + 26 tokens) runs far past the window."""
    cfg = get_smoke_config("gemma3-4b")
    assert cfg.max_window() is None and {s.attn.window for s in cfg.all_specs()} == {8, None}
    bat, calls, eng = port_trace("gemma3-4b", "batched")
    ref, _, _ = port_trace("gemma3-4b", "reference")
    want = jax_reference_trace("gemma3-4b")
    for field in FIELDS:
        assert bat[field] == ref[field], field
        assert bat[field] == want[field], field
    assert calls["paged_attention"] > 0 and eng.kv.flushes > 0
    assert bat["stats"][-1]["demoted"] > 0
