"""The port's training step and loop against the JAX package's, and the
ports of ``tests/test_train.py``.

One ``make_train_step`` from the same weights and batch (numpy from a
seed) in both packages, float32 on the CPU, at ``accum`` 1 and 2: the
loss within 1e-5, the gradient norm within 1e-5 relative, and the
updated parameters as ``test_train_step_matches_jax`` states.
"""

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.launch.train import make_train_step, train_loop  # noqa: E402
from repro_torch.models import nn  # noqa: E402
from repro_torch.models.model import init_params, loss_fn, params_from_jax  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TINY = "tinyllama-1.1b"


def jax_pair(arch, seed=0):
    jcfg = jax_smoke_config(arch)
    jp = jax_init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, get_smoke_config(arch), params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", [TINY, "phi3.5-moe-42b-a6.6b"])
def test_train_step_matches_jax(arch, accum):
    """One step at the full learning rate.  AdamW's first step moves an
    element by ``lr·g/(|g|+eps)``, so an element whose gradient is at
    float32's rounding noise (|g| below 1e-4 of its leaf's largest; the
    gradients agree to 2.3e-6 of that, ``test_torch_train_models.py``)
    may move either way: there only ``|Δ| <= 2·lr`` holds.  Everywhere
    else the parameters agree within 1e-6 plus 1e-4 of the step's largest
    change (reached: 6.0e-8 of a change of 1.1e-3; the noise-level
    elements differ by up to 5.7e-5; losses equal, gradient norms within
    1.1e-7 relative)."""
    jcfg, jp, tcfg, tp = jax_pair(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
    lr = 1e-3
    jo, to = joptim.AdamWConfig(lr=lr), optim.AdamWConfig(lr=lr)
    jp2, _, jm = jax.jit(jax_make_train_step(jcfg, jo, accum=accum))(
        jp, joptim.init(jp, jo), {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    tp2, tstate, tm = make_train_step(tcfg, to, accum=accum)(tp, optim.init(tp, to), batch)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(tm["skipped"]) == int(jm["skipped"]) == 0 and int(tstate.step) == 1
    for key in ("ce", "z_loss", "aux"):
        assert abs(float(tm[key]) - float(jm[key])) <= 1e-5, key
    # the step's gradient (the mean over its microbatches), to tell
    # noise-level elements apart
    leaves = [x.detach().requires_grad_(True) for x in nn.tree_leaves(tp)]
    grads = [0.0] * len(leaves)
    for i in range(accum):
        mb = {k: v.reshape(accum, -1, *v.shape[1:])[i] for k, v in batch.items()}
        loss, _ = loss_fn(nn.tree_unflatten(tp, leaves), tcfg, mb)
        for j, g in enumerate(torch.autograd.grad(loss, leaves, allow_unused=True)):
            grads[j] = None if g is None else grads[j] + g
    jl = jax.tree_util.tree_leaves(jp2)
    moved = max(float(jnp.abs(a - b).max()) for a, b in
                zip(jl, jax.tree_util.tree_leaves(jp)))
    for a, b, g in zip(jl, nn.tree_leaves(tp2), grads):
        err = np.abs(b.numpy() - np.asarray(a))
        assert err.max() <= 2 * lr
        if g is None:
            continue
        g = g.abs().numpy()
        above = g > 1e-4 * g.max()
        assert err[above].max(initial=0.0) <= 1e-6 + 1e-4 * moved


def test_loss_decreases():
    cfg = get_smoke_config(TINY)
    rep = train_loop(cfg, DataConfig(seq_len=64, global_batch=4), AdamWConfig(lr=1e-3),
                     steps=20, log_every=0, device="cpu")
    assert rep.losses[-1] < rep.losses[0]
    assert rep.skipped == 0
    assert len(rep.grad_norms) == len(rep.step_seconds) == 20


def test_grad_accumulation_equivalence():
    """accum=2 matches accum=1 on the same global batch (up to fp)."""
    cfg = get_smoke_config(TINY)
    opt_cfg = AdamWConfig(lr=1e-3, clip_norm=None)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = optim.init(params, opt_cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (4, 32))
                            .astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    p1, _, _ = make_train_step(cfg, opt_cfg, accum=1)(params, opt, batch)
    p2, _, _ = make_train_step(cfg, opt_cfg, accum=2)(params, opt, batch)
    err = max(float((a - b).abs().max()) for a, b in
              zip(nn.tree_leaves(p1), nn.tree_leaves(p2)))
    assert err < 5e-5, f"accumulated params diverge: {err}"


def test_donated_step_equals_functional_step():
    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b")
    opt_cfg = AdamWConfig(lr=1e-3)
    params = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    opt = optim.init(params, opt_cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 16))
                            .astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    want = make_train_step(cfg, opt_cfg)(params, opt, batch)
    got = make_train_step(cfg, opt_cfg, donate=True)(params, opt, batch)
    assert got[0] is params
    for a, b in zip(nn.tree_leaves(want[:2]), nn.tree_leaves(got[:2])):
        assert torch.equal(a, b)


def test_checkpoint_restart_exact():
    """kill/restart: the resumed run reproduces the uninterrupted run."""
    cfg = get_smoke_config(TINY)
    dc = DataConfig(seq_len=32, global_batch=4)
    d1, d2 = tempfile.mkdtemp(), tempfile.mkdtemp()
    try:
        kw = dict(ckpt_every=100, log_every=0, device="cpu")
        full = train_loop(cfg, dc, AdamWConfig(lr=1e-3), steps=12, ckpt_dir=d1, **kw)
        train_loop(cfg, dc, AdamWConfig(lr=1e-3), steps=6, ckpt_dir=d2, **kw)
        resumed = train_loop(cfg, dc, AdamWConfig(lr=1e-3), steps=12, ckpt_dir=d2, **kw)
        assert resumed.resumed_from == 6
        assert resumed.steps_run == 6
        # the same trajectory, bit for bit on one device
        assert resumed.losses == full.losses[6:]
    finally:
        shutil.rmtree(d1, ignore_errors=True)
        shutil.rmtree(d2, ignore_errors=True)


@pytest.mark.parametrize("donate", [False, True])
def test_nan_containment(donate):
    """A poisoned step is skipped, params and state unchanged, the counter ticks."""
    cfg = get_smoke_config(TINY)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = optim.init(params, AdamWConfig(lr=1e-3))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), donate=donate)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 16))
                            .astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    params["final_norm"]["scale"][0] = float("nan")
    before = [x.clone() for x in nn.tree_leaves((params, opt))]
    new_p, new_opt, metrics = step(params, opt, batch)
    assert int(metrics["skipped"]) == 1
    for a, b in zip(before, nn.tree_leaves((new_p, new_opt))):
        assert torch.equal(a, b, ) or (a.isnan() == b.isnan()).all() and \
            torch.equal(a.nan_to_num(), b.nan_to_num())
    assert int(new_opt.step) == 0


def test_cli_trains_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", TINY, "--smoke",
         "--device", "cpu", "--steps", "3"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "done: 3 steps, resumed_from=None" in proc.stdout
