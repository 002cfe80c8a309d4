"""The port in bfloat16 against the JAX package, on the CPU.

* The MoE combine of ``repro/models/moe.py:133-135`` at k=2 and k=6:
  JAX's jitted lines give ``bf16(Σ_j f32(ye_j)·f32(bf16(g_j)))``, one
  rounding; ``moe_combine_plain`` equals them bit for bit.
* The two backwards against ``jax.vjp`` of the jitted lines in bfloat16:
  the dispatch's (XLA transposes the repeat of the token rows into a sum
  over the k gates in bfloat16, rounded after each add; the port's is the
  combine with unit gates and ``round_each``) and the combine's ``dye``
  bit for bit.  The combine's ``dvals`` are the cotangent of the
  bfloat16 gates, which XLA sums in bfloat16 (32-element windows, each
  add rounded), while the port keeps float32 sums: they are held within
  the bound of that rounding, ``(d/2 + 1) · 2^-8 · Σ_d |ye·dy|``.
* deepseek-v2-lite's smoke ``decode_step`` with ``top_k`` 6 in both
  configs, from JAX's ``init_params(dtype=bfloat16)``, against JAX's
  jitted step over 8 steps: the logits within 8 bfloat16 ulps of the
  largest logit, 2^-5 of it (reached 1.46e-2 of it at step 7, 6.0e-3 at
  step 0).  The two frameworks round bfloat16 intermediates at other
  places: XLA keeps each residual sum of the jitted step in float32 for
  the norm after it, where the port's eager ``decode_step`` rounds it
  (the serving engine's batched step follows XLA there), so the logits
  are not bit for bit and their gap grows with the steps.
* phi3.5-moe's smoke training step in bfloat16 (float32 AdamW state)
  for three steps against JAX's jitted step: losses within 2^-8 of
  JAX's, bfloat16's unit roundoff (reached 3.7e-4 at step 3); and the port's
  ``train_loop(dtype=bfloat16)`` runs finite, its weights bfloat16.
* ``moe_route``'s plan at deepseek-v2-lite's router for T past the
  16,384 tokens whose tile counts the kernel's last block stages in
  shared memory (beyond them it scans them in its global scratch).
* ``configs.ARCHS`` equals JAX's list.

The serving lifecycles in bfloat16 are in ``test_torch_bf16_serving.py``
(batched plane) and ``test_torch_bf16_serving_reference.py``.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.kernels import router_topk as rt  # noqa: E402
from repro_torch.launch.train import make_train_step, train_loop  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import nn as tnn  # noqa: E402

BF16_ULP = 2.0 ** -8  # bfloat16's unit roundoff


def bf16_tree(arch, **moe):
    """JAX's and the port's smoke configs (``moe`` replaced in each MoE
    block), JAX's ``init_params(dtype=bfloat16)`` and the port's copy."""
    def cut(cfg):
        if not moe:
            return cfg
        stacks = tuple((tuple(dataclasses.replace(s, moe=dataclasses.replace(s.moe, **moe))
                              if s.moe is not None else s for s in pat), n)
                       for pat, n in cfg.stacks)
        return dataclasses.replace(cfg, stacks=stacks)

    jcfg, tcfg = cut(jax_smoke_config(arch)), cut(get_smoke_config(arch))
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    tp = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# --------------------------------------------------------------------- #
# the combine and the backwards
# --------------------------------------------------------------------- #
def moe_case(k, seed=0, T=16, d=64, E=8, C=16):
    """ye (E*C, d), a slot per assignment (distinct kept slots, about a
    fifth dropped), gates that sum to 1, dy (T, d): float32 numpy."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(E * C)[:T * k]
    slot = np.where(rng.random(T * k) < 0.8, perm, E * C).astype(np.int32)
    ye = rng.standard_normal((E * C, d)).astype(np.float32)
    g = rng.random((T, k)).astype(np.float32)
    g /= g.sum(axis=1, keepdims=True)
    dy = rng.standard_normal((T, d)).astype(np.float32)
    return ye, slot, g, dy


def jax_combine(ye, slot, g, T, k, d):
    """repro/models/moe.py:133-135."""
    ye_flat = jnp.concatenate([ye, jnp.zeros((1, d), ye.dtype)], axis=0)
    yk = ye_flat[slot.reshape(-1)].reshape(T, k, d)
    return jnp.sum(yk * g[..., None].astype(yk.dtype), axis=1)


def jax_dispatch(xt, slot, T, k, d, EC):
    """repro/models/moe.py:121-125 (the scatter-add into zeros)."""
    xe = jnp.zeros((EC + 1, d), dtype=xt.dtype)
    return xe.at[slot.reshape(-1)].add(jnp.repeat(xt, k, axis=0).reshape(T * k, d))[:EC]


@pytest.mark.parametrize("k", [2, 6])
def test_combine_plain_matches_jax_jitted_lines_bit_for_bit(k):
    ye, slot, g, _ = moe_case(k)
    T, d = g.shape[0], ye.shape[1]
    want = f32(jax.jit(jax_combine, static_argnums=(3, 4, 5))(
        jnp.asarray(ye, jnp.bfloat16), jnp.asarray(slot), jnp.asarray(g), T, k, d))
    E_C = ye.shape[0]
    got = md.moe_combine_plain(torch.from_numpy(ye).bfloat16().reshape(E_C, 1, d),
                               torch.from_numpy(slot), torch.from_numpy(g))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # float32 is as it always was: the gated terms added in ascending j
    y32 = md.moe_combine_plain(torch.from_numpy(ye).reshape(E_C, 1, d),
                               torch.from_numpy(slot), torch.from_numpy(g))
    rows = np.concatenate([ye, np.zeros((1, d), np.float32)])[slot].reshape(T, k, d)
    ref = rows[:, 0] * g[:, 0, None]
    for j in range(1, k):
        ref = ref + rows[:, j] * g[:, j, None]
    np.testing.assert_array_equal(y32.numpy(), ref)


@pytest.mark.parametrize("k", [2, 6])
def test_backwards_match_jax_grad(k):
    ye, slot, g, dy = moe_case(k, seed=k)
    T, d, EC = g.shape[0], ye.shape[1], ye.shape[0]
    # the combine's backward: jax.vjp of the jitted lines
    _, vjp = jax.vjp(jax.jit(lambda a, b: jax_combine(a, jnp.asarray(slot), b, T, k, d)),
                     jnp.asarray(ye, jnp.bfloat16), jnp.asarray(g))
    dye_j, dg_j = vjp(jnp.asarray(dy, jnp.bfloat16))
    dye, dvals = md.moe_combine_bwd_plain(
        torch.from_numpy(dy).bfloat16(), torch.from_numpy(ye).bfloat16().reshape(EC, 1, d),
        torch.from_numpy(slot), torch.from_numpy(g))
    assert dye.dtype == torch.bfloat16 and dvals.dtype == torch.float32
    np.testing.assert_array_equal(dye.float().numpy().reshape(EC, d), f32(dye_j))
    rows = np.concatenate([f32(jnp.asarray(ye, jnp.bfloat16)),
                           np.zeros((1, d), np.float32)])[slot].reshape(T, k, d)
    dyb = f32(jnp.asarray(dy, jnp.bfloat16))
    bound = (d / 2 + 1) * BF16_ULP * np.abs(rows * dyb[:, None, :]).sum(-1)
    assert (np.abs(dvals.numpy() - np.asarray(dg_j)) <= bound).all()
    # the dispatch's backward: the combine with unit gates, rounded after each add
    x = np.random.default_rng(k + 10).standard_normal((T, d)).astype(np.float32)
    dxe = np.random.default_rng(k + 20).standard_normal((EC, d)).astype(np.float32)
    _, vjp2 = jax.vjp(jax.jit(lambda xt: jax_dispatch(xt, jnp.asarray(slot), T, k, d, EC)),
                      jnp.asarray(x, jnp.bfloat16))
    (dx_j,) = vjp2(jnp.asarray(dxe, jnp.bfloat16))
    src = np.full(EC, -1, np.int32)
    kept = slot < EC
    src[slot[kept]] = np.nonzero(kept)[0] // k
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    xe = md.Dispatch.apply(xt, torch.from_numpy(src), torch.from_numpy(slot), EC, 1, False)
    np.testing.assert_array_equal(xe.detach().float().numpy().reshape(EC, d), f32(
        jax_dispatch(jnp.asarray(x, jnp.bfloat16), jnp.asarray(slot), T, k, d, EC)))
    xe.backward(torch.from_numpy(dxe).bfloat16().reshape(EC, 1, d))
    assert xt.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(xt.grad.float().numpy(), f32(dx_j))


# --------------------------------------------------------------------- #
# decode and training
# --------------------------------------------------------------------- #
def test_deepseek_decode_step_matches_jax_in_bfloat16():
    jcfg, jp, tcfg, tp = bf16_tree("deepseek-v2-lite-16b", top_k=6)
    B, S = 2, 8
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    step = jax.jit(lambda p, t, st, c: jmodel.decode_step(p, jcfg, t, st, c))
    jst = jmodel.init_decode_state(jcfg, B, S + 2)
    tst = tmodel.init_decode_state(tcfg, B, S + 2, device="cpu")
    for t in range(S):
        cur = np.full((B,), t, np.int32)
        jl, jst = step(jp, jnp.asarray(toks[:, t:t + 1]), jst, jnp.asarray(cur))
        tl, tst = tmodel.decode_step(tp, tcfg, torch.from_numpy(toks[:, t:t + 1]), tst,
                                     torch.from_numpy(cur))
        want, got = f32(jl), tl.float().numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got - want).max() <= 8 * BF16_ULP * np.abs(want).max(), t


def test_phi35_moe_training_matches_jax_in_bfloat16():
    jcfg, jp, tcfg, tp = bf16_tree("phi3.5-moe-42b-a6.6b")
    rng = np.random.default_rng(1)
    lr = 1e-3
    jo, to = joptim.AdamWConfig(lr=lr), optim.AdamWConfig(lr=lr)
    jstep = jax.jit(jax_make_train_step(jcfg, jo))
    tstep = make_train_step(tcfg, to)
    js, ts = joptim.init(jp, jo), optim.init(tp, to)
    for i in range(3):
        toks = rng.integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
        labels = rng.integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        tp, ts, tm = tstep(tp, ts, {"tokens": torch.from_numpy(toks),
                                    "labels": torch.from_numpy(labels)})
        assert int(tm["skipped"]) == int(jm["skipped"]) == 0
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= BF16_ULP * float(jm["loss"]), i
    # the weights keep JAX's dtypes leaf for leaf (bfloat16 but the
    # router), the AdamW moments stay float32
    jl = jax.tree_util.tree_leaves(jp)
    tl = [t for t in tnn.tree_leaves(tp) if t is not None]
    assert [str(a.dtype) for a in jl] == [str(t.dtype).replace("torch.", "") for t in tl]
    assert {t.dtype for t in tnn.tree_leaves((ts.m, ts.v, ts.master))} == {torch.float32}
    rep = train_loop(tcfg, DataConfig(seq_len=16, global_batch=4), optim.AdamWConfig(),
                     steps=2, dtype=torch.bfloat16, log_every=0, device="cpu")
    assert rep.skipped == 0 and all(np.isfinite(rep.losses)) and len(rep.losses) == 2


# --------------------------------------------------------------------- #
# the route's plan, the registry
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("T", [16384 + 64, 32768])
def test_route_plan_takes_deepseek_prefill_32k(T):
    """deepseek-v2-lite's router (T, 2048) @ (2048, 64), k = 6: the plan
    and the wrapper's checks take T past 16,384 tokens (the kernel's last
    block scans the tiles' counts in its global scratch there)."""
    d, E, k = 2048, 64, 6
    plan = rt.route_plan(T, d, E, 132)
    assert plan["TM"] == 64 and plan["NT"] == -(-T // 64) and plan["NT"] * E > 1 << 14
    assert plan["NC"] * plan["DC"] >= d and plan["NC"] >= 1
    rt._check_route(torch.empty((T, d), device="meta"), torch.empty((d, E), device="meta"),
                    k, max(1, int(1.25 * T * k / E)))


def test_archs_equal_jax():
    assert tconfigs.ARCHS == jconfigs.ARCHS
