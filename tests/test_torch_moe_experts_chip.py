"""On the card: ``moe_experts`` against its plain version, and the MoE
layer's decode with no host sync.  Each test skips on a machine without
CUDA; run them on the card with

    PYTHONPATH=src python -m pytest -q -m chip tests/test_torch_moe_experts_chip.py

The kernel sums over k in another order than cuBLAS, so in float32 the
filled rows are held within 1e-5 of the largest |y| of the plain
version.  In bfloat16 they are held within 8e-3 of the largest |y| of
the float32 products of the same bfloat16 inputs (h and ye are rounded
to bfloat16 once each: the kernel read up to 3.6e-3 there, the plain
bfloat16 einsums up to 5.4e-3).  The rows past the count are left unwritten and are not
compared.
"""

import pytest

torch = pytest.importorskip("torch")

REL = {"float32": 1e-5, "bfloat16": 8e-3}
# (d, E, k, F, T, C): phi3.5-moe's decode at 64 lanes and chat's 7, its
# prefills at the drop-free C = T, its training capacity (1.25), and
# deepseek-v2-lite's decode
CASES = {
    "phi3.5_decode_T64": (4096, 16, 2, 6400, 64, 64),
    "phi3.5_chat_decode_T7": (4096, 16, 2, 6400, 7, 7),
    "phi3.5_prefill_T512": (4096, 16, 2, 6400, 512, 512),
    "phi3.5_prefill_T2048": (4096, 16, 2, 6400, 2048, 2048),
    "phi3.5_capacity_1.25_T2048": (4096, 16, 2, 6400, 2048, 320),
    "deepseek_decode_T8": (2048, 64, 6, 1408, 8, 1),
}
# bfloat16: decode, the drop-free prefill, the training capacity, and
# deepseek's decode (the TMA boxes past d = 2048 and F = 1408's edges)
BF16_CASES = ["phi3.5_decode_T64", "phi3.5_chat_decode_T7", "phi3.5_prefill_T2048",
              "phi3.5_capacity_1.25_T2048", "deepseek_decode_T8"]
_weights = {}


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.launch.serve import strict_fp32

    strict_fp32()
    return torch.device("cuda")


def routed(dev, d, E, k, F, T, C, seed, dtype=torch.float32):
    """Expert slots in ``dtype`` filled by the kernels' own route and
    dispatch, and weights of ``init_moe``'s scale (one set a width and
    dtype, reused)."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((T, d), generator=gen, device=dev)
    w = torch.randn((d, E), generator=gen, device=dev) * 0.02
    r = ops.moe_route(x, w, k, C, impl="kernel")
    xe = ops.moe_dispatch(x.to(dtype), r.src, E, C, impl="kernel")
    key = (d, E, F, dtype)
    if key not in _weights:
        _weights.clear()
        _weights[key] = tuple(t.to(dtype) for t in (
            torch.randn((E, d, F), generator=gen, device=dev) / d ** 0.5,
            torch.randn((E, d, F), generator=gen, device=dev) / d ** 0.5,
            torch.randn((E, F, d), generator=gen, device=dev) / F ** 0.5))
    return xe, r.counts, _weights[key]


def check_against_plain(name, dtype):
    from repro_torch.kernels import moe_experts as mx
    from repro_torch.kernels import ops

    dev = card()
    d, E, k, F, T, C = CASES[name]
    xe, counts, ws = routed(dev, d, E, k, F, T, C, seed=len(name), dtype=dtype)
    launches, before = mx.moe_experts.launches, ops.moe_expert_rows()
    ye = ops.moe_experts(xe, counts, *ws, assignments=T * k, impl="kernel")
    after = ops.moe_expert_rows()
    assert ye.dtype == dtype
    ref = ops.moe_experts(xe.float(), counts, *(w.float() for w in ws), assignments=T * k,
                          impl="ref")
    filled = counts.clamp(max=C)
    mask = torch.arange(C, device=dev) < filled[:, None]
    err = (ye.float() - ref)[mask].abs().max().item()
    assert bool(torch.isfinite(ye[mask]).all())
    assert err <= REL[str(dtype).removeprefix("torch.")] * ref[mask].abs().max().item(), err
    assert mx.moe_experts.launches == launches + 1
    assert after["rows"] - before["rows"] == int(filled.sum())
    assert after["slots"] - before["slots"] == E * C


@pytest.mark.chip
@pytest.mark.parametrize("name", list(CASES))
def test_moe_experts_matches_its_plain_version(name):
    check_against_plain(name, torch.float32)


@pytest.mark.chip
@pytest.mark.parametrize("name", BF16_CASES)
def test_moe_experts_bf16_matches_float32_products(name):
    check_against_plain(name, torch.bfloat16)


def check_decode_step_makes_no_host_sync(dtype):
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import decode_step, init_decode_state, init_params

    dev = card()
    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                         dtype=dtype)
    B, P = 4, 8
    states = init_decode_state(cfg, B, P, dtype=dtype, device=dev)
    tokens = torch.randint(0, cfg.vocab, (B, 1), device=dev)
    cur = torch.zeros((B,), dtype=torch.int32, device=dev)
    with torch.no_grad():
        decode_step(params, cfg, tokens, states, cur)  # builds and loads the kernels
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        before = ops.moe_expert_rows()
        torch.cuda.set_sync_debug_mode("error")
        try:
            decode_step(params, cfg, tokens, states, cur + 1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    after = ops.moe_expert_rows()
    moe = [s.moe for s in cfg.all_specs() if s.moe is not None]
    assert ops.launch_counts()["moe_experts"] == len(moe)
    m = moe[0]
    assert after["rows"] - before["rows"] == len(moe) * B * m.top_k
    assert after["slots"] - before["slots"] == len(moe) * m.n_experts * max(
        1, int(m.capacity_factor * B * m.top_k / m.n_experts))


@pytest.mark.chip
def test_a_decode_step_of_an_moe_model_makes_no_host_sync():
    """``decode_step`` of phi3.5-moe's smoke model (its MoE layers on
    ``moe_experts``) under ``set_sync_debug_mode("error")``: any host sync
    raises.  Two launches counted a step (one an MoE layer), and the
    drop-free layers compute T·k rows of E·C."""
    check_decode_step_makes_no_host_sync(torch.float32)


@pytest.mark.chip
def test_a_bf16_decode_step_of_an_moe_model_makes_no_host_sync():
    """The same in bfloat16, whose experts run the tensor-core kernel."""
    check_decode_step_makes_no_host_sync(torch.bfloat16)
