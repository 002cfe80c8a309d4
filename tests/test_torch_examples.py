"""The port's examples (``repro_torch.examples``) against the JAX
package's (``examples/``, imported by path).

``quickstart`` prints JAX's text exactly, and that text is the constant
``chip_smoke.py`` holds the card machine's run to.  ``serve_tiered
--short`` on JAX's weights (converted through numpy) prints JAX's
placement stats, paused pages, migrations and tokens, in both demos
(pause/resume on gemma3-4b's smoke config; Poisson traffic on
tinyllama's).  ``lm_100m()`` has JAX's parameter count, and
``train_e2e`` runs 3 steps of a 2-layer cut at S=32, checkpoints, and a
relaunch to step 8 resumes from step 3, the loss falling in both.
"""

import contextlib
import importlib.util
import io
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.examples import quickstart, serve_tiered, train_e2e  # noqa: E402
from repro_torch.models import nn  # noqa: E402
from repro_torch.models.model import init_params, params_from_jax  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stdout_of(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return buf.getvalue(), out


def test_quickstart_prints_jax_numbers_and_the_smoke_constant(monkeypatch):
    jax_qs = load(REPO / "examples" / "quickstart.py", "jax_quickstart")
    want, _ = stdout_of(jax_qs.main)
    got, _ = stdout_of(quickstart.main)
    assert got == want
    smoke = load(REPO / "chip_smoke.py", "chip_smoke_constants")
    assert smoke.QUICKSTART_OUTPUT == want


@pytest.mark.parametrize("traffic", [None, "poisson"])
def test_serve_tiered_short_equals_jax(traffic, monkeypatch):
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.model import init_params as jax_init_params

    jax_st = load(REPO / "examples" / "serve_tiered.py", "jax_serve_tiered")
    argv = ["serve_tiered", "--short"] + (["--traffic", traffic] if traffic else [])
    monkeypatch.setattr(sys, "argv", argv)
    want, _ = stdout_of(jax_st.main)

    arch = "tinyllama-1.1b" if traffic else "gemma3-4b"
    jp = jax_init_params(jax.random.PRNGKey(0), jax_smoke_config(arch))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    args = serve_tiered.parse_args(argv[1:] + ["--device", "cpu"])
    demo = serve_tiered.traffic_demo if traffic else serve_tiered.pause_resume_demo
    got, report = stdout_of(demo, args, params)
    assert got == want
    assert report["engine"].device.type == "cpu"


def test_lm_100m_has_jax_parameter_count():
    jax_e2e = load(REPO / "examples" / "train_e2e.py", "jax_train_e2e")
    from repro.models import nn as jnn
    from repro.models.model import init_params as jax_init_params

    jcfg = jax_e2e.lm_100m()
    shapes = jax.eval_shape(lambda k: jax_init_params(k, jcfg), jax.random.PRNGKey(0))
    want = jnn.count_params(shapes)
    cfg = train_e2e.lm_100m()
    assert cfg.n_layers == jcfg.n_layers == 10
    assert nn.count_params(init_params(cfg, torch.Generator(), device="meta")) == want


def test_train_e2e_runs_checkpoints_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    common = ["--layers", "2", "--seq-len", "32", "--batch", "2", "--device", "cpu",
              "--ckpt-dir", ckpt, "--ckpt-every", "3"]
    out, first = stdout_of(train_e2e.main, ["--steps", "3"] + common)
    assert first.steps_run == 3 and first.resumed_from is None
    assert first.losses[-1] < first.losses[0]
    assert "params: 49.8M" in out and "ms/step" in out
    assert sorted(p.name for p in Path(ckpt).iterdir()) == ["step_0000000003"]
    # five more steps: two at a warmup's lr are within the batch-to-batch noise
    out, again = stdout_of(train_e2e.main, ["--steps", "8"] + common)
    assert again.resumed_from == 3 and again.steps_run == 5
    assert "resumed_from=3" in out


def test_zipf_ranks_draw_as_numpy_2_0_does():
    """The traces' Zipf sampler equals numpy 2.0's ``Generator.zipf``
    draw for draw, generator state included (this suite's numpy)."""
    from repro_torch.core.trace import zipf_ranks

    assert np.__version__.startswith("2.0.")
    for a in (1.05, 1.2, 1.6, 3.0):
        want, got = np.random.default_rng(11), np.random.default_rng(11)
        assert np.array_equal(want.zipf(a, 4000), zipf_ranks(got, a, 4000))
        assert want.random() == got.random()
