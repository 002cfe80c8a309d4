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


def expert_calls(monkeypatch):
    """A list that grows by one each time ``moe_fwd`` takes the
    filled-slot path (``ops.moe_experts``)."""
    calls, real = [], ops.moe_experts

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "moe_experts", counted)
    return calls


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
def test_moe_fwd_matches_jax(experts, shape, capacity_factor, monkeypatch):
    d = 64
    jcfg, jp, tcfg, tp = moe_pair(3, d, dict(experts, capacity_factor=capacity_factor))
    rng = np.random.default_rng(11)
    x = (decode_batch(rng, d) if shape == "decode"
         else rng.standard_normal((1, 47, d)).astype(np.float32))
    y_j, aux_j = jmoe.moe_fwd(jp, jcfg, jnp.asarray(x))
    calls = expert_calls(monkeypatch)
    y_t, aux_t = tmoe.moe_fwd(tp, tcfg, torch.from_numpy(x))
    assert calls == [1], "the experts run over the filled slots (moe_experts)"
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


@pytest.mark.parametrize("capacity", [1, 3])
@pytest.mark.parametrize("experts", [
    pytest.param(dict(n_experts=16, top_k=2, d_ff_expert=96), id="16e-top2"),
    pytest.param(dict(n_experts=8, top_k=3, d_ff_expert=64, n_shared=2,
                      d_ff_shared=128), id="8e-top3-shared"),
])
def test_moe_fwd_capacity_override_matches_jax(experts, capacity):
    """An explicit ``capacity`` replaces the factor's in both packages."""
    d = 64
    jcfg, jp, tcfg, tp = moe_pair(4, d, dict(experts))
    x = np.random.default_rng(12).standard_normal((1, 47, d)).astype(np.float32)
    y_j, aux_j = jmoe.moe_fwd(jp, jcfg, jnp.asarray(x), capacity=capacity)
    y_t, aux_t = tmoe.moe_fwd(tp, tcfg, torch.from_numpy(x), capacity=capacity)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), atol=1e-6)


# --------------------------------------------------------------------- #
# the routing stage alone: moe_route_plain, moe_dispatch_plain and
# moe_combine_plain, which a CPU tensor runs and the kernels are held to
# on the card
# --------------------------------------------------------------------- #
def route_case(name):
    """``(x (T, d), w (d, E), k, C)`` from numpy; C by the engine's formula
    at the case's capacity factor."""
    rng = np.random.default_rng(sum(map(ord, name)))
    T, d, E, k, factor = {"decode": (8, 64, 16, 2, 1.25), "prefill": (47, 64, 16, 2, 1.25),
                          "drop_free": (47, 64, 16, 2, 8.0), "ties": (8, 32, 16, 3, 1.25),
                          "64e_top6": (100, 48, 64, 6, 1.25),
                          # deepseek-v2-lite's decode routes: E=64, k=6, C=1
                          "deepseek_decode_T2": (2, 48, 64, 6, 1.25),
                          "deepseek_decode_T8": (8, 48, 64, 6, 1.25),
                          "k8": (16, 32, 64, 8, 1.25), "T1": (1, 64, 16, 2, 1.25),
                          "all_dropped": (8, 64, 16, 2, 1.25),
                          "odd_d": (9, 37, 16, 2, 1.25)}[name]
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (0.3 * rng.standard_normal((d, E))).astype(np.float32)
    if name == "decode":
        x[5:] = x[5]  # pad lanes
    if name == "ties":
        # zero rows tie every expert; a row whose one nonzero entry is
        # x[t, 0] > 0 has logits x[t, 0] * w[0], exact, and w[0]'s three
        # equal largest entries tie for the top
        x[:] = 0.0
        x[3:, 0] = np.abs(rng.standard_normal(T - 3)) + 0.1
        w[0] = 0.1 * rng.random(E)
        w[0, [3, 9, 12]] = 1.0
    return x, w, k, max(1, int(factor * T * k / E))


def fcfs(idx, E, C):
    """First come, first served over the flat assignments, one at a time."""
    T, k = idx.shape
    count = np.zeros(E, np.int64)
    slot = np.empty(T * k, np.int64)
    src = np.full(E * C, -1, np.int64)
    for a, e in enumerate(idx.reshape(-1)):
        pos = count[e]
        count[e] += 1
        slot[a] = e * C + pos if pos < C else E * C
        if pos < C:
            src[e * C + pos] = a // k
    return slot, src, count


def jax_route(x, w, K, C):
    """``repro/models/moe.py:90-119`` on ``xt = x``: probs, gates, experts,
    aux and slots."""
    T, E = x.shape[0], w.shape[1]
    logits = jnp.asarray(x) @ jnp.asarray(w)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True), 1e-9)
    me = probs.mean(axis=0)
    ce = jnp.zeros((E,), jnp.float32).at[gate_idx.reshape(-1)].add(1.0) / (T * K)
    aux = E * jnp.sum(me * ce)
    flat_e = gate_idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    counts = jnp.zeros((E,), jnp.int32).at[flat_e].add(1)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1]])
    pos_sorted = jnp.arange(T * K, dtype=jnp.int32) - starts[flat_e[order]]
    pos = jnp.zeros((T * K,), jnp.int32).at[order].set(pos_sorted).reshape(T, K)
    slot = jnp.where(pos < C, gate_idx * C + pos, E * C)
    return probs, gate_vals, gate_idx, aux, slot.reshape(-1)


ROUTE_CASES = ["decode", "prefill", "drop_free", "ties", "64e_top6"]


@pytest.mark.parametrize("name", ROUTE_CASES)
def test_moe_route_plain_slots_are_first_come_first_served(name):
    x, w, k, C = route_case(name)
    r = ops.moe_route(torch.from_numpy(x), torch.from_numpy(w), k, C)
    slot, src, count = fcfs(r.idx.numpy(), w.shape[1], C)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.src.numpy(), src)
    np.testing.assert_array_equal(r.counts.numpy(), count)
    assert r.slot.dtype == r.src.dtype == r.counts.dtype == r.idx.dtype == torch.int32
    dropped = int((count - C).clip(min=0).sum())
    assert (dropped == 0) == (name == "drop_free")
    if name == "ties":  # a zero row: the k lowest experts; a tied row: 3, 9, 12
        assert r.idx.tolist() == [[0, 1, 2]] * 3 + [[3, 9, 12]] * 5


@pytest.mark.parametrize("name", ROUTE_CASES)
def test_moe_route_plain_matches_jax_router(name):
    x, w, k, C = route_case(name)
    r = ops.moe_route(torch.from_numpy(x), torch.from_numpy(w), k, C)
    probs, vals, idx, aux, slot = jax_route(x, w, k, C)
    np.testing.assert_allclose(r.logits.numpy(), x @ w, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(r.probs.numpy(), np.asarray(probs), atol=1e-6)
    np.testing.assert_allclose(r.vals.numpy(), np.asarray(vals), atol=1e-6)
    np.testing.assert_array_equal(r.idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(r.slot.numpy(), np.asarray(slot))
    np.testing.assert_allclose(float(r.aux), float(aux), atol=1e-6)


# the dispatch's and combine's edges beside the route's cases: deepseek's
# decode routes, k = 8 (MAX_K), one token, every assignment dropped, an
# odd d
GLUE_CASES = ROUTE_CASES + ["deepseek_decode_T2", "deepseek_decode_T8", "k8", "T1",
                            "all_dropped", "odd_d"]


def glue_case(name):
    """``(x, k, C, E, slot, src, vals)`` of the route of ``route_case(name)``;
    "all_dropped" sends every assignment to the overflow slot."""
    x, w, k, C = route_case(name)
    E = w.shape[1]
    r = ops.moe_route(torch.from_numpy(x), torch.from_numpy(w), k, C)
    slot, src = r.slot, r.src
    if name == "all_dropped":
        slot, src = torch.full_like(slot, E * C), torch.full_like(src, -1)
    return x, k, C, E, slot, src, r.vals


def jax_dispatch(x, slot, k, E, C):
    """``repro/models/moe.py:121-125``: the rows scatter-added into zeros."""
    d = x.shape[1]
    return jnp.zeros((E * C + 1, d), x.dtype).at[slot].add(
        jnp.repeat(x, k, axis=0))[: E * C].reshape(E, C, d)


@pytest.mark.parametrize("name", GLUE_CASES)
def test_moe_dispatch_and_combine_plain_match_jax(name):
    """The slots' rows against ``xe.at[slot].add`` into zeros (exact), and
    the gated gather against ``moe.py:133-135``."""
    x, k, C, E, slot_t, src, vals = glue_case(name)
    T, d = x.shape
    slot = jnp.asarray(slot_t.numpy())
    xe_j = jax_dispatch(jnp.asarray(x), slot, k, E, C)
    xe = ops.moe_dispatch(torch.from_numpy(x), src, E, C)
    np.testing.assert_array_equal(xe.numpy(), np.asarray(xe_j))
    ye = np.random.default_rng(3).standard_normal((E, C, d)).astype(np.float32)
    ye_flat = jnp.concatenate([jnp.asarray(ye).reshape(E * C, d),
                               jnp.zeros((1, d), jnp.float32)], axis=0)
    yk = ye_flat[slot].reshape(T, k, d)
    y_j = jnp.sum(yk * jnp.asarray(vals.numpy())[..., None], axis=1)
    y = ops.moe_combine(torch.from_numpy(ye), slot_t, vals)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-6, rtol=1e-6)
    if name == "all_dropped":
        assert not xe.any() and not y.any()


@pytest.mark.parametrize("name", GLUE_CASES)
def test_moe_dispatch_gradient_plain_matches_jax(name):
    """The dispatch's gradient under autograd (``Dispatch.backward``: the
    combine with unit gates, each token's slot gradients summed) against
    JAX's gradient of the scatter-add, on the plain path."""
    x, k, C, E, slot, src, _ = glue_case(name)
    g = np.random.default_rng(4).standard_normal((E, C, x.shape[1])).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    xe = ops.moe_dispatch(xt, src, E, C, slot=slot)
    (dx,) = torch.autograd.grad(xe, xt, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda v: jax_dispatch(v, jnp.asarray(slot.numpy()), k, E, C),
                     jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), atol=1e-6, rtol=1e-6)
    assert not any(ops.launch_counts().values())


def test_kernels_in_place_tells_the_combine_from_its_backward():
    """The serve and decode profiles read the port's kernels from one table
    of device function names; ``moe_combine_kernel`` must not also count
    ``moe_combine_bwd_kernel``'s launches."""
    from types import SimpleNamespace

    def event(key, count, us):
        return SimpleNamespace(device_type=SimpleNamespace(name="CUDA"), key=key,
                               count=count, self_device_time_total=us)

    ka = [event("void (anonymous namespace)::moe_combine_kernel<true, 8, 1>(...)", 4, 8.0),
          event("void (anonymous namespace)::moe_combine_bwd_kernel<true>(...)", 2, 30.0),
          event("void (anonymous namespace)::moe_dispatch_kernel<true>(...)", 4, 6.0),
          event("aten::mm", 9, 100.0)]
    own = ops.kernels_in_place(ka, steps=2)
    assert own == {"moe_combine": {"launches_per_step": 2.0, "us_per_launch": 2.0},
                   "moe_combine_bwd": {"launches_per_step": 1.0, "us_per_launch": 15.0},
                   "moe_dispatch": {"launches_per_step": 2.0, "us_per_launch": 1.5}}
    assert {n for n, _ in ops.DEVICE_FUNCTIONS} <= set(ops.launch_counts()) | {
        "page_gather+page_scatter"}


def test_plain_moe_path_launches_no_kernel():
    """On the CPU the layer runs the plain versions: no launch is counted."""
    d = 64
    _, _, tcfg, tp = moe_pair(5, d, dict(n_experts=16, top_k=2, d_ff_expert=96))
    ops.reset_launch_counts()
    x = np.random.default_rng(13).standard_normal((2, 9, d)).astype(np.float32)
    tmoe.moe_fwd(tp, tcfg, torch.from_numpy(x))
    assert not any(ops.launch_counts().values())
    assert {"moe_route", "moe_dispatch", "moe_combine", "moe_experts"} <= set(
        ops.launch_counts())


def test_moe_fwd_refuses_a_router_bias():
    _, _, tcfg, tp = moe_pair(6, 32, dict(n_experts=4, top_k=2, d_ff_expert=32))
    tp["router"]["b"] = torch.zeros(4)
    with pytest.raises(ValueError, match="bias"):
        tmoe.moe_fwd(tp, tcfg, torch.zeros((1, 3, 32)))


# --------------------------------------------------------------------- #
# the expert products over the filled slots: moe_experts_plain, which a
# CPU tensor runs and the kernel is held to on the card
# --------------------------------------------------------------------- #
def expert_case(name, F=24):
    """``(xe, counts, C, (wi_gate, wi_up, wo), route)`` of the route of
    ``route_case(name)``, its slots filled by the plain dispatch."""
    x, w, k, C = route_case(name)
    E, d = w.shape[1], x.shape[1]
    r = ops.moe_route(torch.from_numpy(x), torch.from_numpy(w), k, C)
    xe = ops.moe_dispatch(torch.from_numpy(x), r.src, E, C)
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    ws = tuple(torch.from_numpy((rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32))
               for s in ((E, d, F), (E, d, F), (E, F, d)))
    return xe, r.counts, C, ws, r


def filled_rows(counts, C):
    return torch.arange(C) < counts[:, None]


# decode at C = 1 (16 assignments over 16 experts: some drop, some expert
# gets none), drop-free, E = 64 with k = 6, one token (its two experts at
# count = C), deepseek's decode
EXPERT_CASES = ["decode", "drop_free", "64e_top6", "T1", "deepseek_decode_T8"]


@pytest.mark.parametrize("name", EXPERT_CASES)
def test_moe_experts_plain_is_the_einsums_on_the_filled_rows(name):
    """The plain version (the einsums of ``repro/models/moe.py:127-131``
    over every slot, held to JAX by ``test_moe_fwd_matches_jax``) launches
    nothing on the CPU, and the empty slots' rows stay 0 as their
    dispatched rows, at each route's edge case."""
    xe, counts, C, (wg, wu, wo), _ = expert_case(name)
    ops.reset_launch_counts()
    ye = ops.moe_experts(xe, counts, wg, wu, wo, assignments=int(counts.sum()))
    mask = filled_rows(counts, C)
    assert bool(ye[mask].any()) and bool(torch.isfinite(ye).all())
    assert not ye[~mask].any() and not xe[~mask].any()
    assert not any(ops.launch_counts().values())
    held = {"decode": (counts > C).any() and (counts == 0).any(),
            "drop_free": (counts <= C).all(), "64e_top6": counts.numel() == 64,
            "T1": int((counts == C).sum()) == 2, "deepseek_decode_T8": (counts > C).any()}
    assert held[name], f"{name}: counts {counts.tolist()} at C={C}"


@pytest.mark.parametrize("name", ["decode", "drop_free", "64e_top6"])
def test_rows_past_the_count_never_reach_the_combine(name):
    """The kernel leaves the rows of ``ye`` past the count unwritten: with
    NaN there, the combine's output is the same bit for bit."""
    xe, counts, C, (wg, wu, wo), r = expert_case(name)
    ye = ops.moe_experts(xe, counts, wg, wu, wo, assignments=int(counts.sum()))
    y = ops.moe_combine(ye, r.slot, r.vals)
    garbage = ye.clone()
    garbage[~filled_rows(counts, C)] = float("nan")
    assert torch.equal(ops.moe_combine(garbage, r.slot, r.vals), y)


def test_moe_fwd_under_autograd_keeps_the_einsums(monkeypatch):
    """An input that needs a gradient takes the einsums over every slot,
    so every expert weight gets one (``tests/test_torch_train_models.py``
    holds them to JAX's)."""
    d = 64
    tcfg = tmoe.MoeConfig(n_experts=16, top_k=2, d_ff_expert=96)
    tp = tmoe.init_moe(torch.Generator().manual_seed(7), d, tcfg, device="cpu")
    x = np.random.default_rng(14).standard_normal((1, 23, d)).astype(np.float32)
    calls = expert_calls(monkeypatch)
    xt = torch.from_numpy(x).requires_grad_()
    leaves = [tp["wi_gate"], tp["wi_up"], tp["wo"]]
    for t in leaves:
        t.requires_grad_()
    y, _ = tmoe.moe_fwd(tp, tcfg, xt)
    grads = torch.autograd.grad(y.sum(), [xt, *leaves])
    assert calls == []
    assert all(bool(torch.isfinite(g).all()) and bool(g.any()) for g in grads)


@pytest.mark.parametrize("case,want", [
    ("float32", True), ("requires_grad", False), ("requires_grad_no_grad", True),
    ("bfloat16", True), ("float16", False)])
def test_filled_slot_path_is_chosen_by_what_the_input_shows(case, want):
    """float32 and bfloat16 plain tensors with no gradient to carry take
    ``moe_experts``; autograd, and a dtype the kernel does not take, keep
    the einsums."""
    dtype = getattr(torch, case) if case in ("bfloat16", "float16") else torch.float32
    p = {k: torch.zeros(s, dtype=dtype) for k, s in
         (("wi_gate", (4, 8, 12)), ("wi_up", (4, 8, 12)), ("wo", (4, 12, 8)))}
    xe = torch.zeros((4, 3, 8), dtype=dtype)
    if case.startswith("requires_grad"):
        p["wo"].requires_grad_()
    if case == "requires_grad_no_grad":
        with torch.no_grad():
            assert tmoe._filled_only(xe, p) is want
    else:
        assert tmoe._filled_only(xe, p) is want


@pytest.mark.parametrize("E,C,assignments,plan", [
    (16, 64, 128, "skinny"),      # phi3.5-moe decode at 64 lanes, drop-free
    (16, 7, 14, "skinny"),        # chat's decode
    (64, 1, 48, "skinny"),        # deepseek's decode
    (16, 512, 1024, "skinny"),    # a prefill of 512 tokens: 64 rows an expert
    (16, 2048, 4096, "tiled"),    # of 2048 tokens
    (16, 320, 4096, "tiled"),     # phi3.5-moe's training capacity
    (64, 480, 24576, "tiled"),    # deepseek's T = 4096
])
def test_experts_plan_follows_the_mean_filled_rows(E, C, assignments, plan):
    from repro_torch.kernels import moe_experts as mx

    assert mx.experts_plan(E, C, assignments) == plan


def test_moe_experts_kernel_refuses_what_it_cannot_take():
    """The kernel wants CUDA tensors (``impl="kernel"`` on the CPU
    raises); the shapes are checked on any device."""
    from repro_torch.kernels import moe_experts as mx

    xe, counts, _, ws, _ = expert_case("decode")
    n = int(counts.sum())
    with pytest.raises(ValueError, match="CUDA"):
        ops.moe_experts(xe, counts, *ws, assignments=n, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        mx.moe_experts(xe, counts, *ws, assignments=n)
    with pytest.raises(ValueError, match="wo"):
        ops.moe_experts(xe, counts, ws[0], ws[1], ws[0], assignments=n)
    assert ops.moe_expert_rows()["rows"] == 0
