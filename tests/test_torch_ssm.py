"""The port's recurrent mixers (``models/ssm.py``) against the JAX package's.

Mamba2's ``_segsum`` and chunked SSD scan (with and without an initial
state), ``mamba2_fwd``, ``mlstm_fwd`` and ``slstm_fwd`` values and VJPs
(the input's and every weight's) at S=21 with chunks of 8, so that the
last chunk pads, and each ``*_decode`` step and its state from a random
state; then the ports of ``test_mlstm_chunked_exactness`` and
``test_mamba2_chunked_exactness`` (``tests/test_models.py:132``,
``:151``), chunked forward against the recurrent decode at their 1e-5,
and the same check for the sLSTM's loop.  JAX weights reach the port
through ``params_from_jax``; inputs are numpy from a seed; float32 on
the CPU.

Tolerances: values and states within 1e-5 (absolute and relative); each
gradient leaf within 1e-4 of that leaf's max-abs plus 1e-6, and finite.
Reached on this tree: ``_segsum`` within 4.8e-7, forward values within
7.2e-7, decode steps and states within 6.0e-7, gradients within 1.4e-6
of their leaf's max-abs (the sLSTM's), chunked against recurrent within
6.0e-7 (JAX's own: 7.7e-7).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import nn as tnn  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402

TOL = 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-6
B, S, D_MODEL = 2, 21, 32

MIXERS = {
    # config kwargs, init, fwd, init_state, decode, input scale
    "mamba2": (dict(d_model=D_MODEL, d_state=16, head_dim=8, chunk=8), "Mamba2Config",
               "init_mamba2", "mamba2_fwd", "mamba2_init_state", "mamba2_decode", 0.5),
    "mlstm": (dict(d_model=D_MODEL, n_heads=4, chunk=8), "MlstmConfig", "init_mlstm",
              "mlstm_fwd", "mlstm_init_state", "mlstm_decode", 1.0),
    "slstm": (dict(d_model=D_MODEL, n_heads=4), "SlstmConfig", "init_slstm", "slstm_fwd",
              "slstm_init_state", "slstm_decode", 1.0),
}


def to_torch(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


def grad_close(got, want, what=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert np.isfinite(got).all(), f"{what}: a gradient is not finite"
    err = np.abs(got - want).max()
    assert err <= GRAD_REL * np.abs(want).max() + GRAD_ABS, \
        f"{what}: {err} vs max {np.abs(want).max()}"


def mixer(name):
    kw, cfg_cls, init, fwd, init_state, decode, scale = MIXERS[name]
    jcfg, tcfg = getattr(jssm, cfg_cls)(**kw), getattr(tssm, cfg_cls)(**kw)
    jp = getattr(jssm, init)(jax.random.PRNGKey(0), jcfg)
    return (jcfg, tcfg, jp, to_torch(jp), (getattr(jssm, fwd), getattr(tssm, fwd)),
            (getattr(jssm, init_state), getattr(tssm, init_state)),
            (getattr(jssm, decode), getattr(tssm, decode)), scale)


# --------------------------------------------------------------------- #
# Mamba2's pieces
# --------------------------------------------------------------------- #
def test_segsum_matches_jax():
    a = -np.abs(np.random.default_rng(0).standard_normal((2, 3, 8))).astype(np.float32)
    want = jssm._segsum(jnp.asarray(a))
    got = tssm._segsum(torch.from_numpy(a))
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(np.asarray(want)))
    close(got, want)


@pytest.mark.parametrize("h0", [False, True])
def test_ssd_chunked_matches_jax(h0):
    rng = np.random.default_rng(1 + h0)
    Hh, P, N = 3, 4, 5
    xh = rng.standard_normal((B, S, Hh, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, Hh)))).astype(np.float32)
    A = -np.linspace(1.0, 4.0, Hh).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    init = rng.standard_normal((B, Hh, P, N)).astype(np.float32) if h0 else None
    args = (xh, dt, A, Bm, Cm)
    yj, hj = jssm._ssd_chunked(*map(jnp.asarray, args), 8,
                               h0=None if init is None else jnp.asarray(init))
    yt, ht = tssm._ssd_chunked(*map(torch.from_numpy, args), 8,
                               h0=None if init is None else torch.from_numpy(init))
    close(yt, yj, what="y")
    close(ht, hj, what="final state")


# --------------------------------------------------------------------- #
# each mixer: forward values and VJPs, one decode step
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(MIXERS))
def test_mixer_fwd_values_and_vjp_match_jax(name):
    jcfg, tcfg, jp, tp, (jfwd, tfwd), _, _, scale = mixer(name)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, S, D_MODEL)) * scale).astype(np.float32)
    dy = rng.standard_normal((B, S, D_MODEL)).astype(np.float32)
    yj, vjp = jax.vjp(lambda p, xx: jfwd(p, jcfg, xx), jp, jnp.asarray(x))
    gpj, gxj = vjp(jnp.asarray(dy))
    leaves = [t.requires_grad_(True) for t in tnn.tree_leaves(tp)]
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = tfwd(tp, tcfg, xt)
    close(yt, yj, what="y")
    grads = torch.autograd.grad(yt, leaves + [xt], torch.from_numpy(dy))
    paths = [p for p, _ in tnn.tree_leaves_with_path(tp)] + ["x"]
    for path, gt, gj in zip(paths, grads, jax.tree_util.tree_leaves(gpj) + [gxj]):
        grad_close(gt, gj, what=f"{name} {path}")


def random_state(name, init_state, cfg, rng):
    """A state one step could not reach from the initial one: random
    values, mLSTM's stabilizer and sLSTM's normalizer in range."""
    st = {k: np.asarray(v) for k, v in init_state(cfg, B).items()}
    out = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in st.items()}
    if name == "slstm":
        out["n"] = np.abs(out["n"]) + 0.5
    return out


@pytest.mark.parametrize("name", list(MIXERS))
def test_mixer_decode_step_and_state_match_jax(name):
    jcfg, tcfg, jp, tp, _, (jinit, _), (jdec, tdec), scale = mixer(name)
    rng = np.random.default_rng(5)
    st = random_state(name, jinit, jcfg, rng)
    x = (rng.standard_normal((B, 1, D_MODEL)) * scale).astype(np.float32)
    yj, sj = jdec(jp, jcfg, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    yt, stt = tdec(tp, tcfg, torch.from_numpy(x), {k: torch.from_numpy(v)
                                                    for k, v in st.items()})
    close(yt, yj, what="y")
    assert sorted(stt) == sorted(sj)
    for k in sj:
        assert stt[k].dtype == torch.float32, k
        close(stt[k], sj[k], what=f"state {k}")


@pytest.mark.parametrize("name", list(MIXERS))
def test_init_state_matches_jax(name):
    jcfg, tcfg, _, _, _, (jinit, tinit), _, _ = mixer(name)
    want = jinit(jcfg, B)
    got = tinit(tcfg, B, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


# --------------------------------------------------------------------- #
# chunked (or looped) forward against the recurrent decode
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(MIXERS))
def test_chunked_forward_equals_recurrent_decode(name):
    """The ports of ``tests/test_models.py:132`` (mLSTM) and ``:151``
    (Mamba2), the same weights and inputs drawn by JAX, and the sLSTM's
    loop alike: the full forward against 21 decode steps, at 1e-5."""
    jcfg, tcfg, _, tp, (_, tfwd), (_, tinit), (_, tdec), scale = mixer(name)
    x = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(1), (B, S, D_MODEL)) * scale))
    with torch.no_grad():
        y_par = tfwd(tp, tcfg, x)
        st = tinit(tcfg, B, device="cpu")
        ys = []
        for t in range(S):
            yt, st = tdec(tp, tcfg, x[:, t:t + 1], st)
            ys.append(yt)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(), atol=1e-5)
