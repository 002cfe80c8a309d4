"""The port's model pieces against the JAX package's, at 1e-5 in float32.

Inputs are made with numpy from a seed and handed to both frameworks.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.models import rope as jrope  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import ffn as tffn  # noqa: E402
from repro_torch.models import nn as tnn  # noqa: E402
from repro_torch.models import rope as trope  # noqa: E402
from repro_torch.models.model import init_params, params_from_jax  # noqa: E402

TOL = 1e-5


def arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


def both_tree(tree):
    """A numpy tree as (JAX tree, torch tree)."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_jax(tree, device="cpu"))


# --------------------------------------------------------------------- #
@pytest.mark.parametrize("bias", [False, True])
def test_nn_dense_embed_rmsnorm(bias):
    rng = np.random.default_rng(0)
    x = arr(rng, 2, 5, 16)
    p = {"w": arr(rng, 16, 24)}
    if bias:
        p["b"] = arr(rng, 24)
    jp, tp = both_tree(p)
    close(tnn.dense(tp, torch.from_numpy(x)), jnn.dense(jp, jnp.asarray(x)))
    table = {"table": arr(rng, 50, 16)}
    ids = rng.integers(0, 50, (3, 7)).astype(np.int32)
    jt, tt = both_tree(table)
    close(tnn.embed(tt, torch.from_numpy(ids)), jnn.embed(jt, jnp.asarray(ids)))
    scale = {"scale": arr(rng, 16)}
    js, ts = both_tree(scale)
    close(tnn.rmsnorm(ts, torch.from_numpy(x)), jnn.rmsnorm(js, jnp.asarray(x)))


@pytest.mark.parametrize("variant", ["rope", "partial", "mrope"])
def test_rope_variants(variant):
    rng = np.random.default_rng(1)
    B, S, H, D = 2, 6, 3, 16
    x = arr(rng, B, S, H, D)
    pos = rng.integers(0, 100, (B, S)).astype(np.int32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if variant == "rope":
        jc, js = jrope.rope_cos_sin(jnp.asarray(pos), D, 500.0)
        tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), D, 500.0)
        close(tc, jc)
        close(ts, js)
        close(trope.apply_rope(tx, tc, ts), jrope.apply_rope(jx, jc, js))
    elif variant == "partial":
        rd = D // 2
        jc, js = jrope.rope_cos_sin(jnp.asarray(pos), rd)
        tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), rd)
        close(trope.apply_rope_partial(tx, tc, ts, rd),
              jrope.apply_rope_partial(jx, jc, js, rd))
    else:
        pos3 = rng.integers(0, 100, (3, B, S)).astype(np.int32)
        sections = (2, 3, 3)
        jc, js = jrope.mrope_cos_sin(jnp.asarray(pos3), D, sections)
        tc, ts = trope.mrope_cos_sin(torch.from_numpy(pos3), D, sections)
        close(tc, jc)
        close(ts, js)
        close(trope.text_mrope_positions(torch.from_numpy(pos)),
              jrope.text_mrope_positions(jnp.asarray(pos)), tol=0)


@pytest.mark.parametrize("rope", ["rope", "rope2d", "mrope", "none"])
def test_make_cos_sin_and_rotate(rope):
    rng = np.random.default_rng(2)
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16, rope=rope,
              mrope_sections=(2, 3, 3))
    jcfg, tcfg = jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    pos = rng.integers(0, 64, (2, 5)).astype(np.int32)
    x = arr(rng, 2, 5, 4, 16)
    jc, js = jattn.make_cos_sin(jcfg, jnp.asarray(pos))
    tc, ts = tattn.make_cos_sin(tcfg, torch.from_numpy(pos))
    if rope == "none":
        assert tc is None and ts is None and jc is None
    else:
        close(tc, jc)
        close(ts, js)
    close(tattn._rotate(tcfg, torch.from_numpy(x), tc, ts),
          jattn._rotate(jcfg, jnp.asarray(x), jc, js))


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (True, 3, 0), (False, None, 0), (True, None, 4)])
def test_reference_attention(causal, window, q_offset):
    rng = np.random.default_rng(3)
    q = arr(rng, 2, 7, 8, 16)
    k = arr(rng, 2, 11, 2, 16)
    v = arr(rng, 2, 11, 2, 16)
    want = jattn.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal, window=window, q_offset=q_offset)
    got = tattn.reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal,
                                    window=window, q_offset=q_offset)
    close(got, want)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_ffn_fwd(kind):
    rng = np.random.default_rng(4)
    d, f = 16, 40
    if kind == "gelu":
        p = {"wi": {"w": arr(rng, d, f), "b": arr(rng, f)},
             "wo": {"w": arr(rng, f, d), "b": arr(rng, d)}}
    else:
        p = {"wi_gate": {"w": arr(rng, d, f)}, "wi_up": {"w": arr(rng, d, f)},
             "wo": {"w": arr(rng, f, d)}}
    jp, tp = both_tree(p)
    x = arr(rng, 3, 5, d)
    close(tffn.ffn_fwd(tp, torch.from_numpy(x), kind),
          jffn.ffn_fwd(jp, jnp.asarray(x), kind))


# --------------------------------------------------------------------- #
def _flatten(tree, prefix=""):
    """{path: leaf} of a tree of dicts, lists and None."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def test_params_from_jax_round_trips_leaf_for_leaf():
    cfg = jax_smoke_config("tinyllama-1.1b")
    jp = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(0), cfg))
    tp = params_from_jax(jp, device="cpu")
    jflat, tflat = _flatten(jp), _flatten(tp)
    assert sorted(jflat) == sorted(tflat)
    for path, want in jflat.items():
        got = tflat[path]
        if want is None:
            assert got is None, path
            continue
        assert isinstance(got, torch.Tensor), path
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)


def test_init_params_matches_jax_tree_names_shapes_dtypes():
    jcfg = jax_smoke_config("tinyllama-1.1b")
    jflat = _flatten(jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg)))
    tp = init_params(get_smoke_config("tinyllama-1.1b"),
                     torch.Generator().manual_seed(0), device="cpu")
    tflat = _flatten(tp)
    assert sorted(jflat) == sorted(tflat)
    for path, want in jflat.items():
        got = tflat[path]
        if want is None:
            assert got is None, path
            continue
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), path
