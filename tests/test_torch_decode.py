"""The port's dense-cache decode and MLA against the JAX package's.

``gqa_decode`` (a full cache, a windowed mask, a rolling buffer, M-RoPE)
and ``mla_decode`` one step from a random cache; ``decode_step`` of all ten
archs' smoke configs over S=10 teacher-forced steps, logits and every
state leaf (zamba2's shared block with nonzero LoRA ``qb``/``ob``;
xlstm-350m within JAX's own float32 spread, see its test), with JAX's
step under ``jax.jit``; the ports of
``test_fwd_decode_parity`` and ``test_rolling_window_cache_matches_full``
(``tests/test_models.py:70``, ``:112``) at their ``atol=5e-5,
rtol=1e-3``; the greedy launcher and the engine's refusal of MLA.  JAX
weights reach the port through ``params_from_jax``; float32 on the CPU.
Tolerances: 1e-5 (absolute and relative) for one mixer step and for
``decode_step`` against JAX.  ``mla_fwd`` against JAX is in
``test_torch_train_models.py``, deepseek-v2-lite's loss and gradients in
its every-arch parametrisation.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.configs import get_smoke_config, list_archs  # noqa: E402
from repro_torch.launch import generate as tgen  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import nn as tnn  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402
from test_torch_models import perturb_lora  # noqa: E402

TOL = 1e-5
PARITY = dict(atol=5e-5, rtol=1e-3)  # tests/test_models.py:87-90
DEEPSEEK = "deepseek-v2-lite-16b"


def to_torch(tree):
    return tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


# --------------------------------------------------------------------- #
# one mixer step from a random cache
# --------------------------------------------------------------------- #
GQA_CASES = {
    # cfg kwargs, S_cache, rolling, mrope positions
    "full": (dict(), 12, False, False),
    "window": (dict(window=5), 12, False, False),
    "rolling": (dict(window=6), 6, True, False),  # cur 3 fills, cur 9 wraps
    "mrope": (dict(rope="mrope", mrope_sections=(2, 1, 1)), 12, False, True),
}


@pytest.mark.parametrize("case", list(GQA_CASES))
def test_gqa_decode_matches_jax(case):
    kw, S_cache, rolling, mrope = GQA_CASES[case]
    a = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, **kw)
    jcfg, tcfg = jattn.AttnConfig(**a), tattn.AttnConfig(**a)
    jp = jattn.init_gqa(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(len(case))
    B = 2
    x = rng.standard_normal((B, 1, 32)).astype(np.float32)
    kc = rng.standard_normal((B, S_cache, 2, 8)).astype(np.float32)
    vc = rng.standard_normal((B, S_cache, 2, 8)).astype(np.float32)
    cur = np.array([3, 9], np.int32)
    pos = cur[:, None]
    if mrope:
        pos = np.stack([pos, pos + 1, pos + 2])  # t, h, w ids that differ
    yj, kj, vj = jattn.gqa_decode(jp, jcfg, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(cur), jnp.asarray(pos), rolling=rolling)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    yt, kt, vt = tattn.gqa_decode(to_torch(jp), tcfg, torch.from_numpy(x), tk, tv,
                                  torch.from_numpy(cur), torch.from_numpy(pos),
                                  rolling=rolling)
    assert kt is tk and vt is tv  # written in place
    close(yt, yj, what="y")
    close(kt, kj, what="k cache")
    close(vt, vj, what="v cache")


def test_mla_decode_matches_jax():
    a = dict(d_model=32, n_heads=4, n_kv_heads=4, head_dim=24, kv_lora_rank=16,
             qk_nope_dim=16, qk_rope_dim=8, v_head_dim=12)
    jcfg, tcfg = jattn.AttnConfig(**a), tattn.AttnConfig(**a)
    jp = jattn.init_mla(jax.random.PRNGKey(5), jcfg)
    tp = to_torch(jp)
    assert sorted(tp) == ["kv_norm", "wkv_a", "wkv_b", "wo", "wq"]
    rng = np.random.default_rng(7)
    B, S_max = 2, 10
    x = rng.standard_normal((B, 1, 32)).astype(np.float32)
    ckv = rng.standard_normal((B, S_max, 16)).astype(np.float32)
    kr = rng.standard_normal((B, S_max, 8)).astype(np.float32)
    cur = np.array([3, 7], np.int32)
    yj, cj, rj = jattn.mla_decode(jp, jcfg, jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(kr),
                                  jnp.asarray(cur), jnp.asarray(cur[:, None]))
    yt, ct, rt = tattn.mla_decode(tp, tcfg, torch.from_numpy(x), torch.from_numpy(ckv.copy()),
                                  torch.from_numpy(kr.copy()), torch.from_numpy(cur),
                                  torch.from_numpy(cur[:, None]))
    close(yt, yj, what="y")
    close(ct, cj, what="ckv cache")
    close(rt, rj, what="krope cache")


# --------------------------------------------------------------------- #
# decode_step of the whole model, against JAX and against forward
# --------------------------------------------------------------------- #
B, S = 2, 10


@functools.lru_cache(maxsize=None)
def decode_runs(arch, seq=S, batch=B, seed=1):
    """JAX's jitted ``decode_step`` and the port's over the same
    teacher-forced tokens from the same weights, and the port's
    ``forward`` over them: ``(jax logits, jax states, port logits, port
    states, port forward logits)``, numpy."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jp = perturb_lora(jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    tp = to_torch(jp)
    shape = (batch, seq) + ((jcfg.n_codebooks,) if jcfg.n_codebooks > 1 else ())
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab, shape).astype(np.int32)
    step = jax.jit(lambda p, t, st, c: jmodel.decode_step(p, jcfg, t, st, c))
    jst = jmodel.init_decode_state(jcfg, batch, seq + 2)
    tst = tmodel.init_decode_state(tcfg, batch, seq + 2, device="cpu")
    jl, tl = [], []
    for t in range(seq):
        cur = np.full((batch,), t, np.int32)
        lg, jst = step(jp, jnp.asarray(toks[:, t:t + 1]), jst, jnp.asarray(cur))
        jl.append(np.asarray(lg))
        lt, tst2 = tmodel.decode_step(tp, tcfg, torch.from_numpy(toks[:, t:t + 1]), tst,
                                      torch.from_numpy(cur))
        assert tst2 is tst  # the caches are updated in place
        tl.append(lt.numpy())
    full, _ = tmodel.forward(tp, tcfg, torch.from_numpy(toks))
    return (np.concatenate(jl, axis=1), jax.tree_util.tree_leaves(jst),
            np.concatenate(tl, axis=1), tnn.tree_leaves(tst), full.detach().numpy())


# no float32 port holds these to JAX at TOL: see the test below
SPREAD_ARCHS = ("xlstm-350m",)


@pytest.mark.parametrize("arch", [a for a in list_archs() if a not in SPREAD_ARCHS])
def test_decode_step_logits_and_states_match_jax(arch):
    jl, jst, tl, tst, _ = decode_runs(arch)
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)
    assert len(jst) == len(tst)
    for i, (a, b) in enumerate(zip(jst, tst)):
        assert tuple(b.shape) == a.shape, i
        close(b, a, what=f"state leaf {i}")


def one_ulp_spread(arch, nudges=4, seed=0):
    """JAX's own float32 spread: per output of ``decode_runs(arch)`` (the
    logits, then each state leaf), the largest change over ``nudges``
    runs of JAX's jitted decode whose weights each moved one ulp up or
    down at random."""
    jcfg = jax_smoke_config(arch)
    jp = perturb_lora(jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    step = jax.jit(lambda p, t, st, c: jmodel.decode_step(p, jcfg, t, st, c))

    def run(p):
        st, logits = jmodel.init_decode_state(jcfg, B, S + 2), []
        for t in range(S):
            lg, st = step(p, jnp.asarray(toks[:, t:t + 1]), st,
                          jnp.full((B,), t, jnp.int32))
            logits.append(np.asarray(lg))
        return [np.concatenate(logits, axis=1)] + jax.tree_util.tree_leaves(st)

    base = run(jp)
    rng = np.random.default_rng(seed)
    spread = [np.zeros(()) for _ in base]
    for _ in range(nudges):
        nudged = run(jax.tree_util.tree_map(lambda a: np.nextafter(
            np.asarray(a), np.where(rng.random(a.shape) < 0.5, -np.inf, np.inf)
            .astype(a.dtype)), jp))
        spread = [np.maximum(sp, np.abs(np.asarray(a) - np.asarray(b)).max())
                  for sp, a, b in zip(spread, base, nudged)]
    return spread


def test_xlstm_decode_step_matches_jax_within_its_own_float32_spread():
    """xlstm-350m's exponential gates make its smoke decode too sensitive
    for TOL: JAX's own decode, with every weight moved by one ulp, moves
    its logits by up to 1.2e-5 and its states by up to 1.2e-4 over the 10
    steps, past TOL, and so would any float32 implementation whose
    roundings differ from XLA's.  The port is held to JAX within TOL plus
    that spread, leaf by leaf (reached: the port's differences run from
    1.5e-7 to 6.9e-5, the nudged runs' from 6.0e-8 to 1.2e-4)."""
    jl, jst, tl, tst, _ = decode_runs("xlstm-350m")
    spread = one_ulp_spread("xlstm-350m")
    assert tl.shape == jl.shape and len(jst) == len(tst)
    for i, (want, got, sp) in enumerate(zip([jl] + jst, [tl] + [t.numpy() for t in tst],
                                            spread)):
        want = np.asarray(want)
        assert got.shape == want.shape, i
        err = np.abs(got - want) - TOL * (1 + np.abs(want))
        assert err.max() <= sp, f"output {i}: {err.max()} past TOL, spread {sp}"


@pytest.mark.parametrize("arch", list_archs())
def test_fwd_decode_parity(arch):
    """Teacher-forced decode matches the port's full forward."""
    _, _, tl, _, full = decode_runs(arch)
    np.testing.assert_allclose(full, tl, **PARITY)


def test_rolling_window_cache_matches_full():
    """gemma3's rolling window cache (smoke window 8, S=20) equals the full
    forward with its window mask."""
    cfg = get_smoke_config("gemma3-4b")
    states = tmodel.init_decode_state(cfg, 1, S + 12, device="cpu")
    assert {tuple(st["k"].shape[2:3]) for stack in states for st in stack} == {(8,), (22,)}
    _, _, tl, _, full = decode_runs("gemma3-4b", seq=20, batch=1, seed=2)
    np.testing.assert_allclose(full, tl, **PARITY)


# --------------------------------------------------------------------- #
# the launcher and the engine
# --------------------------------------------------------------------- #
def test_generate_feeds_back_the_decode_argmax():
    cfg = get_smoke_config(DEEPSEEK)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = tgen.make_prompts(cfg, 2, 6, seed=3, device="cpu")
    res = tgen.generate(cfg, params, prompts, 4)
    assert res["steps"] == 9 and res["logits_finite"] and res["score_finite"]
    assert res["tokens"].shape == (2, 4)
    # the forward over prompt + generated tokens picks the same argmax
    # (the smoke config is drop-free, so forward and decode agree)
    seq = torch.cat([prompts, res["tokens"]], dim=1)
    full, _ = tmodel.forward(params, cfg, seq[:, :-1])
    assert torch.equal(full[:, 5:].argmax(-1).to(torch.int32), res["tokens"])


def test_the_engine_refuses_mla_as_jax_does():
    jcfg = jax_smoke_config(DEEPSEEK)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(ValueError, match="MLA"):
        JaxServingEngine(jcfg, jp, JaxEngineConfig())
    with pytest.raises(ValueError, match="MLA"):
        ServingEngine(get_smoke_config(DEEPSEEK), to_torch(jp), EngineConfig(), device="cpu")


def test_generate_cli_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["generate", "--arch", DEEPSEEK, "--smoke", "--device",
                                     "cpu", "--prompt-len", "5", "--max-new", "3"])
    tgen.main()
    out = capsys.readouterr().out
    assert "3 tokens for each of 2 requests in 7 decode steps on cpu" in out
    assert "finite True" in out
