"""The port's optimizer, offload plan, data pipeline and checkpoints
against the JAX package's.

AdamW runs 3 steps on the same parameters and gradients (numpy from a
seed) in both packages, float32 on the CPU: parameters, moments, master
copy and metrics within 1e-6 absolute plus 1e-6 relative (reached:
1.9e-6 absolute, on a gradient norm near 10).  The offload plan, the
data batches and the schedule's steps are compared exactly.
"""

import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import make_batches as jmake_batches  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.optim import offload as joffload  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config, list_archs  # noqa: E402
from repro_torch.core.types import Tier  # noqa: E402
from repro_torch.data import DataConfig, make_batches  # noqa: E402
from repro_torch.data.pipeline import memmap_stream  # noqa: E402
from repro_torch.models import nn  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.offload import apply_placement, plan_offload  # noqa: E402

TOL = 1e-6


def tree_pair(seed=0, bf16=False):
    """A small mixed tree (dicts, a list, a None) as numpy."""
    rng = np.random.default_rng(seed)
    return {"b": {"w": rng.standard_normal((6, 5)).astype(np.float32),
                  "scale": rng.standard_normal((5,)).astype(np.float32)},
            "a": [rng.standard_normal((4,)).astype(np.float32), None,
                  rng.standard_normal((3, 2)).astype(np.float32)]}


def grads_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda x: (rng.standard_normal(x.shape) * 3)
                                  .astype(np.float32), tree)


def assert_tree_close(jtree, ttree, tol=TOL):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = nn.tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol, rtol=tol)


@pytest.mark.parametrize("master", [True, False])
@pytest.mark.parametrize("clip_norm", [1.0, None])
def test_adamw_three_steps_match_jax(master, clip_norm):
    params = tree_pair()
    jcfg = joptim.AdamWConfig(lr=1e-2, clip_norm=clip_norm, master=master)
    tcfg = optim.AdamWConfig(lr=1e-2, clip_norm=clip_norm, master=master)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_jax(params, device="cpu")
    js, ts = joptim.init(jp, jcfg), optim.init(tp, tcfg)
    sched_j, sched_t = joptim.cosine_schedule(1, 3), optim.cosine_schedule(1, 3)
    for step in range(3):
        g = grads_like(params, step)
        jp, js, jm = joptim.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, jcfg,
                                   sched_j(js.step))
        before = [x.clone() for x in nn.tree_leaves(tp)]
        tp2, ts, tm = optim.update(params_from_jax(g, device="cpu"), ts, tp, tcfg,
                                   sched_t(ts.step))
        # the functional form leaves its inputs alone
        assert all(torch.equal(a, b) for a, b in zip(before, nn.tree_leaves(tp)))
        tp = tp2
        assert int(ts.step) == int(js.step) == step + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=TOL, rtol=TOL)
    assert_tree_close(jp, tp)
    assert_tree_close(js.m, ts.m)
    assert_tree_close(js.v, ts.v)
    assert (ts.master is None) == (not master)
    if master:
        assert_tree_close(js.master, ts.master)


def test_adamw_in_place_and_chunked_equal_functional(monkeypatch):
    params = params_from_jax(tree_pair(1), device="cpu")
    cfg = optim.AdamWConfig(lr=3e-2)
    g = params_from_jax(grads_like(tree_pair(1), 5), device="cpu")
    want_p, want_s, _ = optim.update(g, optim.init(params, cfg), params, cfg)
    monkeypatch.setattr(adamw, "CHUNK", 7)  # leaves of 30 and 6 elements in pieces
    state = optim.init(params, cfg)
    got_p, got_s, _ = optim.update(g, state, params, cfg, inplace=True)
    assert got_p is params and got_s.m is state.m
    for a, b in zip(nn.tree_leaves((want_p, want_s)), nn.tree_leaves((got_p, got_s))):
        assert torch.equal(a, b)


def test_master_copy_kept_for_float32_params():
    p = {"w": torch.ones(3)}
    s = optim.init(p, optim.AdamWConfig(master=True))
    assert s.master["w"].dtype == torch.float32
    assert s.master["w"].data_ptr() != p["w"].data_ptr()


def test_cosine_schedule_and_global_norm_match_jax():
    fj, ft = joptim.cosine_schedule(5, 40, 0.2), optim.cosine_schedule(5, 40, 0.2)
    for s in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        assert float(ft(s)) == pytest.approx(float(fj(s)), abs=1e-7)
        assert float(ft(torch.tensor(s, dtype=torch.int32))) == float(ft(s))
    t = tree_pair(3)
    np.testing.assert_allclose(float(optim.global_norm(params_from_jax(t, device="cpu"))),
                               float(joptim.global_norm(jax.tree_util.tree_map(jnp.asarray, t))),
                               rtol=1e-6)


# --------------------------------------------------------------------- #
# offload plan
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("frac", [3, 7])
def test_offload_plan_equals_jax_leaf_for_leaf(arch, frac):
    jp = jax_init_params(jax.random.PRNGKey(0), jax_smoke_config(arch))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jopt = joptim.init(jp, joptim.AdamWConfig())
    topt = optim.init(tp, optim.AdamWConfig())
    total = sum(x.numel() * x.element_size() for x in nn.tree_leaves(topt))
    assert total == sum(x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(jopt))
    jplan = joffload.plan_offload(jopt, total // frac)
    tplan = plan_offload(topt, total // frac)
    assert list(tplan.placement.items()) == [(k, Tier(int(v))) for k, v in
                                             jplan.placement.items()]
    assert tplan.used_bytes == jplan.used_bytes
    assert 0 < tplan.fraction_fast() < 1
    out = apply_placement(topt, tplan)  # identity on the CPU
    assert all(a is b for a, b in zip(nn.tree_leaves(out), nn.tree_leaves(topt)))
    assert nn.tree_signature(out) == nn.tree_signature(topt)


# --------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", list_archs())
def test_synthetic_batches_equal_jax_bit_for_bit(arch):
    kw = dict(seq_len=16, global_batch=8, dp_rank=1, dp_size=2, seed=7, n_patches=3)
    jb, tb = jmake_batches(JDataConfig(**kw), jax_smoke_config(arch)), \
        make_batches(DataConfig(**kw), get_smoke_config(arch))
    for _ in range(3):
        a, b = next(jb), next(tb)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_memmap_batches_equal_jax_bit_for_bit():
    toks = np.random.default_rng(0).integers(0, 1 << 20, 4000).astype(np.uint32)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "corpus.bin")
        toks.tofile(path)
        kw = dict(seq_len=32, global_batch=4, dp_rank=0, dp_size=2, seed=3,
                  source="memmap", path=path)
        jb = jmake_batches(JDataConfig(**kw), jax_smoke_config("tinyllama-1.1b"))
        tb = make_batches(DataConfig(**kw), get_smoke_config("tinyllama-1.1b"))
        for _ in range(4):
            a, b = next(jb), next(tb)
            for k in a:
                assert np.array_equal(a[k], b[k])
        with pytest.raises(ValueError, match="needs a path"):
            next(memmap_stream(DataConfig(seq_len=4, global_batch=2, source="memmap"),
                               get_smoke_config("tinyllama-1.1b")))


# --------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------- #
def test_checkpoint_round_trip_with_state_and_bf16(tmp_path):
    tree = {"params": {"w": torch.randn(3, 4), "h": torch.randn(5).to(torch.bfloat16),
                       "layers": [{"b": torch.arange(6, dtype=torch.int32)}, None]},
            "opt": optim.init({"w": torch.randn(2)}, optim.AdamWConfig())}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, tree, blocking=True)
    step, got = mgr.restore_latest(tree)
    assert step == 3
    assert isinstance(got["opt"], optim.AdamWState)
    for a, b in zip(nn.tree_leaves(tree), nn.tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_async_save_snapshots_a_copy_of_cpu_tensors(tmp_path):
    """The background write must not see the next step's in-place update."""
    w = torch.zeros(1 << 16)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": w})
    w.add_(1.0)  # the next step, before the write is done
    mgr.wait()
    _, got = mgr.restore_latest({"w": w})
    assert torch.count_nonzero(got["w"]) == 0


def test_checkpoint_keeps_the_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"a": torch.full((2,), float(s))})
    mgr.wait()
    assert mgr.steps() == [3, 4]
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]


def test_checkpoint_atomicity():
    """A torn tmp dir is never picked up as a restore point (the port of
    ``tests/test_train.py::test_checkpoint_atomicity``)."""
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        tree = {"a": torch.ones(4), "b": {"c": torch.zeros(2, 2)}}
        mgr.save(5, tree, blocking=True)
        os.makedirs(os.path.join(d, ".tmp-9"), exist_ok=True)
        os.makedirs(os.path.join(d, "step_0000000009"), exist_ok=True)
        assert mgr.steps() == [5]
        step, restored = mgr.restore_latest(tree)
        assert step == 5
        assert torch.equal(restored["a"], tree["a"])


def test_checkpoint_treedef_mismatch_rejected():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, {"a": torch.ones(4)}, blocking=True)
        with pytest.raises(ValueError, match="treedef"):
            mgr.restore(1, {"a": torch.ones(4), "b": torch.ones(1)})
        with pytest.raises(ValueError, match="treedef"):
            mgr.restore(1, {"a": [torch.ones(4)]})
