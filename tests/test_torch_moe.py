"""The port's MoE layer against the JAX package's, on the same weights.

Weights come from the JAX ``init_moe`` and are converted through numpy
by ``params_from_jax``; inputs are made with numpy from a seed.  At
capacity factor 1.25 experts overflow and assignments are dropped, so
the port must drop the same ones (first come, first served in token
order, padded decode lanes included).  ``y`` within 1e-5, the aux loss
within 1e-6, both float32.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import init_params, param_bytes, params_from_jax  # noqa: E402


def moe_pair(seed, d, cfg_kw):
    jcfg = jmoe.MoeConfig(**cfg_kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, jcfg)
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, tmoe.MoeConfig(**cfg_kw), params_from_jax(np_p, device="cpu")


def decode_batch(rng, d, real=5, lanes=8):
    """``lanes`` rows of one token; rows past ``real`` are identical pad
    lanes, as the engine's padded decode batch (token 0 in every pad)."""
    x = rng.standard_normal((lanes, 1, d)).astype(np.float32)
    x[real:] = x[real]
    return x


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
@pytest.mark.parametrize("shape", ["decode", "prefill"])
@pytest.mark.parametrize("experts", [
    pytest.param(dict(n_experts=16, top_k=2, d_ff_expert=96), id="16e-top2"),
    pytest.param(dict(n_experts=8, top_k=3, d_ff_expert=64, n_shared=2,
                      d_ff_shared=128), id="8e-top3-shared"),
])
def test_moe_fwd_matches_jax(experts, shape, capacity_factor):
    d = 64
    jcfg, jp, tcfg, tp = moe_pair(3, d, dict(experts, capacity_factor=capacity_factor))
    rng = np.random.default_rng(11)
    x = (decode_batch(rng, d) if shape == "decode"
         else rng.standard_normal((1, 47, d)).astype(np.float32))
    y_j, aux_j = jmoe.moe_fwd(jp, jcfg, jnp.asarray(x))
    y_t, aux_t = tmoe.moe_fwd(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), atol=1e-6)
    # at 1.25 some expert overflows its capacity, so assignments drop
    T, E, K = x.shape[0] * x.shape[1], tcfg.n_experts, tcfg.top_k
    C = max(1, int(capacity_factor * T * K / E))
    logits = torch.from_numpy(x.reshape(T, d)) @ tp["router"]["w"]
    counts = torch.bincount(ops.router_topk(logits, K)[2].reshape(-1).long(),
                            minlength=E)
    assert (int(counts.max()) > C) == (capacity_factor == 1.25)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "phi3.5-moe-42b-a6.6b"])
def test_published_widths_match_jax_tree(arch):
    """At the published widths (32 layers of phi3.5-moe: 167 GB), the port's
    parameter tree has the JAX tree's leaves, shapes and dtypes; both are
    built as shapes only (``jax.eval_shape``, the ``meta`` device)."""
    jtree = jax.eval_shape(lambda k: jax_init_params(k, jax_get_config(arch)),
                           jax.random.PRNGKey(0))
    ttree = init_params(get_config(arch), torch.Generator(), device="meta")
    jleaves = jax.tree_util.tree_leaves_with_path(jtree)
    tleaves = jax.tree_util.tree_leaves_with_path(ttree)
    assert [jax.tree_util.keystr(p) for p, _ in jleaves] == \
        [jax.tree_util.keystr(p) for p, _ in tleaves]
    for (path, j), (_, t) in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape, jax.tree_util.keystr(path)
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
    assert param_bytes(get_config(arch)) == sum(j.size * j.dtype.itemsize
                                                for _, j in jleaves)
