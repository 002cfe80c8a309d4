"""The port's training forward, loss and gradients against the JAX package's.

Weights come from the JAX ``init_params`` (converted through numpy by
``params_from_jax``), inputs are made with numpy from a seed, and
gradients are ``jax.value_and_grad`` against ``torch.autograd.grad``,
float32 on the CPU (the MoE kernels' plain versions inside their
autograd Functions).  Tolerances: a loss within 1e-5; each gradient
leaf within 1e-4 of that leaf's max-abs plus 1e-6; attention values and
vjps within 1e-5.  Reached on this tree: losses within 9.6e-7,
gradient leaves within 3.3e-6 of their max-abs (gemma3-4b's global
``wk``), attention within 2.6e-7 (values) and 2.9e-6 (vjps), MoE
gradients within 3.2e-7 of their max-abs.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_smoke_config, list_archs  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import router_topk as rt  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import nn as tnn  # noqa: E402
from repro_torch.models import transformer as ttrans  # noqa: E402

LOSS_TOL = 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-6
ATTN_TOL = 1e-5


def assert_grads_close(jgrads, tgrads, what=""):
    """Each leaf within 1e-4 of its max-abs plus 1e-6, leaf paths equal."""
    jl = jax.tree_util.tree_leaves_with_path(jgrads)
    tl = tnn.tree_leaves_with_path(tgrads)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p.replace("/", "") for p, _ in tl]
    for (path, g), (_, t) in zip(jl, tl):
        g = np.asarray(g)
        t = t.detach().numpy()
        assert np.isfinite(t).all(), f"{what} {jax.tree_util.keystr(path)}: not finite"
        err = np.abs(t - g).max()
        assert err <= GRAD_REL * np.abs(g).max() + GRAD_ABS, \
            f"{what} {jax.tree_util.keystr(path)}: {err} vs max {np.abs(g).max()}"


def torch_value_and_grad(fn, params):
    """``fn(params) → (loss, aux)`` → ``((loss, aux), grads)`` as JAX's."""
    leaves = tnn.tree_leaves(params)
    req = [x.detach().requires_grad_(True) for x in leaves]
    loss, aux = fn(tnn.tree_unflatten(params, req))
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(req, grads)]
    return (loss.detach(), aux), tnn.tree_unflatten(params, grads)


# --------------------------------------------------------------------- #
# chunked attention
# --------------------------------------------------------------------- #
ATTN_CASES = {
    # B, S, T, H, Hkv, D, causal, window, q_offset, kv_chunk
    "causal-gqa-ragged": (2, 40, 40, 8, 2, 8, True, None, 0, 16),
    "window-masks-chunks": (1, 37, 37, 4, 2, 8, True, 8, 0, 8),
    "chunks-masked-for-every-row": (2, 8, 40, 4, 4, 8, True, None, 0, 16),
    "q-offset": (1, 8, 40, 6, 2, 8, True, None, 32, 16),
    "q-offset-window": (1, 8, 40, 6, 3, 8, True, 5, 32, 8),
    "noncausal-window": (1, 12, 12, 4, 1, 8, False, 4, 0, 5),
    "default-chunk": (1, 20, 20, 4, 2, 16, True, None, 0, None),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_values_and_vjp_match_jax(case):
    B, S, T, H, Hkv, D, causal, window, q_offset, kv_chunk = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    dout = rng.standard_normal((B, S, H, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_chunk=kv_chunk)

    out_j, vjp = jax.vjp(lambda a, b, c: jattn.chunked_attention(a, b, c, **kw),
                         *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(dout))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out_t = tattn.chunked_attention(qt, kt, vt, **kw)
    grads_t = torch.autograd.grad(out_t, (qt, kt, vt), torch.from_numpy(dout))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=ATTN_TOL, rtol=ATTN_TOL)
    for gt, gj in zip(grads_t, grads_j):
        assert torch.isfinite(gt).all(), "a masked branch leaked a NaN into the gradient"
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=ATTN_TOL, rtol=ATTN_TOL)
    # and the naive oracle, where no row is empty
    ref = tattn.reference_attention(qt, kt, vt, causal=causal, window=window,
                                    q_offset=q_offset)
    np.testing.assert_allclose(out_t.detach().numpy(), ref.detach().numpy(),
                               atol=ATTN_TOL, rtol=ATTN_TOL)


def test_attention_fwd_refuses_mla():
    cfg = tattn.AttnConfig(d_model=16, n_heads=2, n_kv_heads=2, head_dim=8,
                           kv_lora_rank=8)
    with pytest.raises(NotImplementedError, match="MLA and the SSM mixers"):
        tattn.attention_fwd({}, cfg, torch.zeros(1, 2, 16), torch.zeros(1, 2))


# --------------------------------------------------------------------- #
# the whole model: loss and every gradient leaf
# --------------------------------------------------------------------- #
B, S = 2, 24


@functools.lru_cache(maxsize=None)
def model_pair(arch):
    jcfg = jax_smoke_config(arch)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, get_smoke_config(arch), tp


def make_batch(cfg, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, shape).astype(np.int32)}
    if cfg.vision_stub:
        batch["patch_embeds"] = (rng.standard_normal((B, 4, cfg.d_model)) * 0.02
                                 ).astype(np.float32)
    if mask:
        batch["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return batch


def both_losses(arch, batch, **kw):
    jcfg, jp, tcfg, tp = model_pair(arch)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jcfg, b, **kw), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    (lt, mt), gt = torch_value_and_grad(
        lambda p: tmodel.loss_fn(p, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 **kw), tp)
    return (lj, mj, gj), (lt, mt, gt)


def check_loss_and_grads(arch, batch, **kw):
    (lj, mj, gj), (lt, mt, gt) = both_losses(arch, batch, **kw)
    assert abs(float(lt) - float(lj)) <= LOSS_TOL
    for key in ("ce", "z_loss", "aux"):
        assert abs(float(mt[key].detach()) - float(mj[key])) <= LOSS_TOL, key
    assert_grads_close(gj, gt, arch)
    return gt


@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_every_gradient_match_jax(arch):
    check_loss_and_grads(arch, make_batch(model_pair(arch)[2]))


@pytest.mark.parametrize("arch,variant", [
    ("musicgen-medium", "ce_chunk"),  # codebook logits
    ("qwen2-vl-2b", "ce_chunk"),  # tied vocab, patches
    ("tinyllama-1.1b", "ce_onehot"),
    ("musicgen-medium", "loss_mask"),  # a (B, S) mask over (B, S, K) labels
])
def test_loss_variants_match_jax(arch, variant):
    cfg = model_pair(arch)[2]
    kw = {"ce_chunk": dict(ce_chunk=8), "ce_onehot": dict(ce_onehot=True),
          "loss_mask": {}}[variant]
    check_loss_and_grads(arch, make_batch(cfg, seed=3, mask=variant == "loss_mask"), **kw)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "phi3.5-moe-42b-a6.6b", "gemma3-4b"])
def test_remat_gradients_equal_plain_bit_for_bit(arch):
    """Recomputing each block in backward runs the same operations."""
    _, _, tcfg, tp = model_pair(arch)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(tcfg, seed=5).items()}
    (l0, _), g0 = torch_value_and_grad(lambda p: tmodel.loss_fn(p, tcfg, batch), tp)
    (l1, _), g1 = torch_value_and_grad(lambda p: tmodel.loss_fn(p, tcfg, batch, remat=True), tp)
    assert torch.equal(l0, l1)
    for a, b in zip(tnn.tree_leaves(g0), tnn.tree_leaves(g1)):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="mesh, shardings and dry-run"):
        tmodel.loss_fn(tp, tcfg, batch, remat=True, remat_policy=object())


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "musicgen-medium", "qwen2-vl-2b"])
def test_forward_last_only_and_positions_match_jax(arch):
    jcfg, jp, tcfg, tp = model_pair(arch)
    batch = make_batch(tcfg, seed=7)
    pe = batch.get("patch_embeds")
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None] + 3, (B, S))
    if tcfg.mrope:
        pos = np.stack([pos, pos + 1, pos + 2])  # t, h, w ids that differ
    pos = np.ascontiguousarray(pos)
    for last_only in (False, True):
        lj, aj = jmodel.forward(jp, jcfg, jnp.asarray(batch["tokens"]), jnp.asarray(pos),
                                None if pe is None else jnp.asarray(pe), last_only=last_only)
        lt, at = tmodel.forward(tp, tcfg, torch.from_numpy(batch["tokens"]),
                                torch.from_numpy(pos),
                                None if pe is None else torch.from_numpy(pe),
                                last_only=last_only)
        assert lt.shape == lj.shape
        np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------- #
# MoE: gradients through the routing, dispatch and combine Functions
# --------------------------------------------------------------------- #
MOE_CASES = {
    "drop-free": (dict(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=8.0), None),
    "drops": (dict(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=1.25), None),
    "capacity-2": (dict(n_experts=8, top_k=3, d_ff_expert=32), 2),
    "shared-experts": (dict(n_experts=4, top_k=2, d_ff_expert=32, n_shared=2,
                            d_ff_shared=48, capacity_factor=1.0), None),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_fwd_gradients_match_jax(case):
    kw, capacity = MOE_CASES[case]
    d = 32
    jcfg, tcfg = jmoe.MoeConfig(**kw), tmoe.MoeConfig(**kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(4), d, jcfg)
    tp = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 20, d)).astype(np.float32)
    dy = rng.standard_normal((2, 20, d)).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_fwd(p, jcfg, xx, capacity=capacity)
        return jnp.sum(y * dy) + 3.0 * aux

    (gpj, gxj) = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = [t.requires_grad_(True) for t in tnn.tree_leaves(tp)]
    y, aux = tmoe.moe_fwd(tp, tcfg, xt, capacity=capacity)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + 3.0 * aux, leaves + [xt])
    assert_grads_close(gpj, tnn.tree_unflatten(tp, grads[:-1]), case)
    assert_grads_close({"x": gxj}, {"x": grads[-1]}, case)
    for leaf, g in zip(leaves, grads):
        assert g.abs().max() > 0  # router, experts and input all get a gradient
    # dropped assignments really occur where the case says so
    T, E, K = 40, tcfg.n_experts, tcfg.top_k
    C = capacity or max(1, int(tcfg.capacity_factor * T * K / E))
    r = ops.moe_route(xt.detach().reshape(T, d), tp["router"]["w"].detach(), K, C)
    assert bool((r.slot == E * C).any()) == (case != "drop-free")


def test_moe_functions_equal_plain_autograd():
    """The Functions' hand-written backward against autograd through the
    plain versions' own torch ops, on the same route."""
    rng = np.random.default_rng(2)
    T, d, E, K, C = 30, 16, 6, 2, 7  # drops: 60 assignments, 42 slots
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((d, E)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    wexp = torch.from_numpy(rng.standard_normal((E, d, d)).astype(np.float32))

    def run(fn_route, fn_dispatch, fn_combine):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        r = fn_route(xx, ww)
        ye = torch.einsum("ecd,edf->ecf", fn_dispatch(xx, r), wexp).contiguous()
        y = fn_combine(ye, r)
        return torch.autograd.grad((y * dy).sum() + 5.0 * r.aux, (xx, ww))

    with_fns = run(lambda a, b: ops.moe_route(a, b, K, C),
                   lambda a, r: ops.moe_dispatch(a, r.src, E, C, slot=r.slot),
                   lambda ye, r: ops.moe_combine(ye, r.slot, r.vals))
    plain = run(lambda a, b: rt.moe_route_plain(a, b, K, C),
                lambda a, r: md.moe_dispatch_plain(a, r.src, E, C),
                lambda ye, r: md.moe_combine_plain(ye, r.slot, r.vals))
    for a, b in zip(with_fns, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-5)


def test_moe_combine_bwd_plain_equals_autograd_of_combine():
    rng = np.random.default_rng(6)
    E, C, d, T, K = 5, 8, 12, 9, 3
    ye = torch.from_numpy(rng.standard_normal((E, C, d)).astype(np.float32))
    vals = torch.from_numpy(rng.random((T, K)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    # each slot at most once; some assignments dropped, one token all dropped
    slots = rng.permutation(E * C)[:T * K].astype(np.int32)
    slots[[1, 7, 12, 13, 14]] = E * C
    slot = torch.from_numpy(slots)
    yr, vr = ye.clone().requires_grad_(True), vals.clone().requires_grad_(True)
    dye_a, dvals_a = torch.autograd.grad(md.moe_combine_plain(yr, slot, vr), (yr, vr), dy)
    dye, dvals = md.moe_combine_bwd_plain(dy, ye, slot, vals)
    assert torch.equal(dye, dye_a)
    np.testing.assert_allclose(dvals.numpy(), dvals_a.numpy(), atol=1e-6, rtol=1e-6)
    kept = set(slots[slots < E * C].tolist())
    empty = [s for s in range(E * C) if s not in kept]
    assert torch.count_nonzero(dye.reshape(E * C, d)[empty]) == 0
    assert torch.count_nonzero(dvals[4]) == 0  # token 4: slots 12-14 all dropped
    # the ops entry point takes the plain side for a CPU tensor
    got = ops.moe_combine_bwd(dy, ye, slot, vals)
    assert torch.equal(got[0], dye) and torch.equal(got[1], dvals)


def test_moe_kernel_wrappers_refuse_cpu_tensors():
    ye, slot, vals, dy = torch.zeros(2, 2, 4), torch.zeros(4, dtype=torch.int32), \
        torch.ones(2, 2), torch.zeros(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        md.moe_combine_bwd(dy, ye, slot, vals)
    with pytest.raises(ValueError, match="impl='kernel' needs a CUDA tensor"):
        ops.moe_combine_bwd(dy, ye, slot, vals, impl="kernel")
    with pytest.raises(ValueError, match="needs the route's slot"):
        ops.moe_dispatch(torch.zeros(2, 4, requires_grad=True),
                         torch.zeros(4, dtype=torch.int32), 2, 2)


def test_block_and_stack_refuse_later_blocks():
    spec = ttrans.BlockSpec(kind="mamba2")
    with pytest.raises(NotImplementedError, match="MLA and the SSM mixers"):
        ttrans.block_fwd({}, spec, torch.zeros(1, 2, 4), torch.zeros(1, 2))
