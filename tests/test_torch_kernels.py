"""The port's kernel modules against the JAX package's Pallas kernels.

Each plain PyTorch version (what a CPU tensor runs) is held against the
Pallas TPU kernel in interpret mode, as ``tests/test_kernels.py`` runs
it, on that file's sweeps and tolerances (``TOL``: 2e-5 in float32,
2e-2 in bfloat16; gather and scatter exact; router probabilities and
values within 1e-6, indices exact).  Inputs are made with numpy
from a seed and handed to both frameworks.  The CUDA kernels themselves
run only on the card (``chip_smoke.py``).
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.page_migrate import page_gather as jax_gather  # noqa: E402
from repro.kernels.page_migrate import page_scatter as jax_scatter  # noqa: E402
from repro.kernels.paged_attention import paged_attention as jax_paged  # noqa: E402
from repro.kernels.ref import paged_attention_ref  # noqa: E402
from repro.kernels.router_topk import router_topk as jax_router  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.kernels import ops, page_migrate  # noqa: E402
from repro_torch.kernels import router_topk as rt  # noqa: E402
from repro_torch.models.attention import reference_attention  # noqa: E402
from repro_torch.kernels.paged_attention import PAD_PAGE_POS, split_plan  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def both(a: np.ndarray, dtype: str):
    """The same numpy data as a JAX array and a CPU tensor of ``dtype``."""
    return (jnp.asarray(a, jnp.float32).astype(JDT[dtype]),
            torch.from_numpy(a).to(TDT[dtype]))


def ints(a):
    a = np.asarray(a, np.int32)
    return jnp.asarray(a), torch.from_numpy(a)


def assert_close(got, want, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32),
        atol=TOL[dtype], rtol=TOL[dtype],
    )


def attn_inputs(seed, B, H, Hkv, P, MP, D, F, dtype):
    rng = np.random.default_rng(seed)
    q = both(rng.standard_normal((B, H, D), np.float32), dtype)
    kp = both(rng.standard_normal((F, Hkv, P, D), np.float32), dtype)
    vp = both(rng.standard_normal((F, Hkv, P, D), np.float32), dtype)
    bt = ints(rng.integers(0, F, (B, MP)))
    return rng, q, kp, vp, bt


# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,Hkv,P,MP,D",
    [
        (2, 4, 2, 8, 4, 32),
        (1, 8, 8, 16, 3, 64),
        (3, 4, 1, 8, 5, 16),
        (1, 16, 4, 32, 2, 128),
    ],
)
def test_paged_attention_length_mode(B, H, Hkv, P, MP, D, dtype):
    rng, q, kp, vp, bt = attn_inputs(B * P + MP, B, H, Hkv, P, MP, D, 24, dtype)
    lengths = ints(rng.integers(1, MP * P + 1, B))
    want = jax_paged(q[0], kp[0], vp[0], bt[0], lengths[0], interpret=True)
    got = ops.paged_attention(q[1], kp[1], vp[1], bt[1], lengths[1])
    assert got.dtype == TDT[dtype]
    assert_close(got, want, dtype)


@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_position_mode(dtype, window):
    """Sparse page subsets, a pad entry and a sliding window — the batched
    serving plane's kernel configuration."""
    _, q, kp, vp, bt = attn_inputs(5, 2, 4, 2, 8, 4, 32, 24, dtype)
    page_pos = ints([[0, 16, 40, PAD_PAGE_POS], [8, 24, 32, 47]])
    q_pos = ints([45, 49])
    want = jax_paged(q[0], kp[0], vp[0], bt[0], page_pos=page_pos[0],
                     q_pos=q_pos[0], window=window, interpret=True)
    got = ops.paged_attention(q[1], kp[1], vp[1], bt[1], page_pos=page_pos[1],
                              q_pos=q_pos[1], window=window)
    assert_close(got, want, dtype)


def test_paged_attention_fully_masked_row_is_zero():
    """A pad lane (trash frame, every entry PAD_PAGE_POS) gives 0, not NaN."""
    _, q, kp, vp, _ = attn_inputs(11, 2, 8, 2, 16, 4, 64, 12, "float32")
    bt = ints([[3, 7, 1, 11], [11, 11, 11, 11]])
    page_pos = ints([[0, 16, 32, PAD_PAGE_POS], [PAD_PAGE_POS] * 4])
    q_pos = ints([40, 0])
    want = jax_paged(q[0], kp[0], vp[0], bt[0], page_pos=page_pos[0],
                     q_pos=q_pos[0], interpret=True)
    got = ops.paged_attention(q[1], kp[1], vp[1], bt[1], page_pos=page_pos[1],
                              q_pos=q_pos[1])
    assert torch.isfinite(got).all()
    assert (got[1] == 0).all()
    assert_close(got, want, "float32")


def test_paged_attention_position_matches_length_mode():
    """On a dense page prefix the two masking modes agree exactly."""
    B, H, Hkv, P, MP, D, F = 2, 8, 4, 8, 4, 32, 16
    _, q, kp, vp, bt = attn_inputs(9, B, H, Hkv, P, MP, D, F, "float32")
    lengths = torch.tensor([13, 30], dtype=torch.int32)
    page_pos = (torch.arange(MP, dtype=torch.int32) * P).expand(B, MP).contiguous()
    o_len = ops.paged_attention(q[1], kp[1], vp[1], bt[1], lengths)
    o_pos = ops.paged_attention(q[1], kp[1], vp[1], bt[1], page_pos=page_pos,
                                q_pos=lengths - 1)
    assert torch.equal(o_len, o_pos)


def test_paged_attention_reads_a_strided_layer_view():
    """The engine passes ``store[:, li]`` of an (F, L, Hkv, P, D) store;
    the result equals attention over a contiguous copy of that layer."""
    rng, q, _, _, bt = attn_inputs(3, 2, 8, 2, 8, 4, 16, 10, "float32")
    store = torch.from_numpy(rng.standard_normal((10, 3, 2, 8, 16), np.float32))
    page_pos = torch.tensor([[0, 8, 16, 24], [0, 8, PAD_PAGE_POS, PAD_PAGE_POS]],
                            dtype=torch.int32)
    q_pos = torch.tensor([30, 12], dtype=torch.int32)
    got = ops.paged_attention(q[1], store[:, 1], store[:, 2], bt[1],
                              page_pos=page_pos, q_pos=q_pos)
    want = jax_paged(q[0], jnp.asarray(store[:, 1].numpy()),
                     jnp.asarray(store[:, 2].numpy()), bt[0],
                     page_pos=jnp.asarray(page_pos.numpy()),
                     q_pos=jnp.asarray(q_pos.numpy()), interpret=True)
    assert_close(got, want, "float32")


# --------------------------------------------------------------------- #
@pytest.mark.parametrize("stores", [1, 2])
@pytest.mark.parametrize(
    "n,f,seed",
    [(1, 8, 0), (4, 16, 7), (8, 24, 42), (3, 12, 100), (2, 9, 55),
     (6, 20, 13), (8, 8, 77), (5, 23, 31),
     # longer than one launch carries by value (the kernel's chunks)
     (page_migrate.MAX_PAIRS + 44, page_migrate.MAX_PAIRS + 60, 9)],
)
def test_page_migrate_round_trip(n, f, seed, stores):
    """gather∘scatter round-trips arbitrary frames of one store or of a
    (K, V) pair of stores, exactly as Pallas does on each store; frames
    are a host int32 tensor, as the kernels take them."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((stores, f, 2, 4, 8)).astype(np.float32)
    idx = rng.choice(f, size=n, replace=False).astype(np.int32)
    frames = torch.from_numpy(idx)
    assert frames.device.type == "cpu" and frames.dtype == torch.int32
    g_jax = [jax_gather(jnp.asarray(s), jnp.asarray(idx), interpret=True) for s in src]
    dst = np.zeros_like(src)
    s_jax = [jax_scatter(jnp.asarray(d), jnp.asarray(idx), g, interpret=True)
             for d, g in zip(dst, g_jax)]
    dst_t = torch.from_numpy(dst.copy())
    if stores == 1:
        g = ops.page_gather(torch.from_numpy(src[0]), frames)
        s = ops.page_scatter(dst_t[0], frames, g)
        assert s.data_ptr() == dst_t.data_ptr(), "page_scatter writes in place"
        g = g[None]
    else:
        g = ops.page_gather(tuple(torch.from_numpy(src)), frames)
        s = ops.page_scatter(tuple(dst_t), frames, g)
        assert [t.data_ptr() for t in s] == [t.data_ptr() for t in dst_t], \
            "page_scatter writes in place"
    assert g.shape == (stores, n, 2, 4, 8)
    np.testing.assert_array_equal(g.numpy(), np.stack([np.asarray(x) for x in g_jax]))
    np.testing.assert_array_equal(dst_t.numpy(), np.stack([np.asarray(x) for x in s_jax]))


def test_page_migrate_trash_frame_duplicates():
    """Padded flush batches repeat the trash frame (a self-copy): the
    duplicate targets carry identical payloads and the result is exact."""
    rng = np.random.default_rng(4)
    store = rng.standard_normal((9, 3, 2, 4, 8)).astype(np.float32)
    trash = 8
    src_idx = np.asarray([2, 5, trash, trash, trash, trash], np.int32)
    dst_idx = np.asarray([6, 1, trash, trash, trash, trash], np.int32)
    js = jnp.asarray(store)
    js = jax_scatter(js, jnp.asarray(dst_idx),
                     jax_gather(js, jnp.asarray(src_idx), interpret=True),
                     interpret=True)
    ts = torch.from_numpy(store.copy())
    ops.page_scatter(ts, torch.from_numpy(dst_idx),
                     ops.page_gather(ts, torch.from_numpy(src_idx)))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,Hkv,S,D,causal,window,bq,bk",
    [
        (1, 4, 4, 128, 64, True, None, 64, 64),
        (2, 8, 2, 96, 32, True, None, 32, 32),
        (1, 4, 2, 200, 64, True, 64, 64, 64),
        (1, 2, 1, 64, 128, True, None, 32, 32),
        (2, 2, 2, 40, 16, False, None, 16, 16),
        (1, 8, 4, 256, 256, True, 128, 128, 128),
    ],
)
def test_flash_attention_sweep(B, H, Hkv, S, D, causal, window, bq, bk, dtype):
    """The sweeps of ``tests/test_kernels.py:26-37``, Pallas in interpret
    mode at that file's block sizes; ``TOL`` as there."""
    rng = np.random.default_rng(S * D + H)
    q = both(rng.standard_normal((B, H, S, D), np.float32), dtype)
    k = both(rng.standard_normal((B, Hkv, S, D), np.float32), dtype)
    v = both(rng.standard_normal((B, Hkv, S, D), np.float32), dtype)
    want = jax_flash(q[0], k[0], v[0], causal=causal, window=window,
                     bq=bq, bk=bk, interpret=True)
    got = ops.flash_attention(q[1], k[1], v[1], causal=causal, window=window)
    assert got.dtype == TDT[dtype] and got.shape == (B, H, S, D)
    assert_close(got, want, dtype)


def test_flash_attention_on_transposed_views_is_prefill_attention():
    """The engine hands the kernel its ``(B, S, H, D)`` projections as
    ``(B, H, S, D)`` views; through them flash attention equals the
    model's full-score ``reference_attention`` (which it replaced in
    prefill), with a window and GQA."""
    rng = np.random.default_rng(21)
    q = torch.from_numpy(rng.standard_normal((1, 47, 8, 32), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 47, 2, 32), np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 47, 2, 32), np.float32))
    for window in (None, 16):
        got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True, window=window)
        want = reference_attention(q, k, v, causal=True, window=window)
        assert_close(got.transpose(1, 2), want.numpy(), "float32")


def test_flash_p_split_keeps_float32_precision():
    """p.V on the tensor cores with bf16 operands: p split into
    ``bf16(p) + bf16(p - bf16(p))`` against bf16 V, float32 sums, stays
    within 2^-17 of sum |p||v| of the float32 product; one rounding of p
    to bf16 does not.  The kernel takes a third part, bf16 of what is
    left: the three hold a softmax's float32 p exactly (3 x 8 bits of
    its 24), so p.V differs from the float32 product only in the order
    of its sums."""
    rng = np.random.default_rng(13)
    s = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32) * 3.0)
    p = torch.softmax(s, dim=-1)
    v = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)).bfloat16().float()
    want = p @ v
    hi = p.bfloat16().float()
    mid = (p - hi).bfloat16().float()
    bound = 2.0 ** -17 * (p.abs() @ v.abs())
    assert bool(((hi @ v + mid @ v) - want).abs().le(bound).all())
    assert not bool(((hi @ v) - want).abs().le(bound).all())
    lo = (p - hi - mid).bfloat16().float()
    assert torch.equal(hi.double() + mid.double() + lo.double(), p.double())
    assert not torch.equal(hi.double() + mid.double(), p.double())


@pytest.mark.parametrize("dtype,offset,D,want", [
    ("bfloat16", 0, 128, "wgmma"), ("bfloat16", 0, 80, "wgmma"),
    ("bfloat16", 1, 64, "cuda cores, element loads"),
    ("bfloat16", 0, 20, "cuda cores, element loads"),
    ("float32", 0, 64, "cuda cores"), ("float32", 1, 64, "cuda cores, element loads")])
def test_flash_kernel_path(dtype, offset, D, want):
    """Which path of the kernel a call takes, by its launch rule: bf16
    rows 16-byte aligned take the warpgroup tensor cores (``wgmma``);
    ``offset`` shifts every row by one element off that alignment."""
    from repro_torch.kernels.flash_attention import kernel_path

    def rows(h):
        flat = torch.zeros(offset + 1 * h * 40 * D, dtype=TDT[dtype])
        return flat[offset:].view(1, h, 40, D)

    assert kernel_path(rows(8), rows(2), rows(2)) == want


def test_flash_kernel_path_needs_stepped_dimensions():
    """A bf16 operand broadcast over heads (stride 0, as ``expand`` gives)
    has no tensor map: it takes the CUDA cores; one KV head is fine."""
    from repro_torch.kernels.flash_attention import kernel_path

    q = torch.zeros((1, 8, 40, 64), dtype=torch.bfloat16)
    one = torch.zeros((1, 1, 40, 64), dtype=torch.bfloat16)
    assert kernel_path(q, one, one) == "wgmma"
    wide = one.expand(1, 2, 40, 64)
    assert kernel_path(q, wide, wide) == "cuda cores"


# The bf16 kernel's launch plan (``wgmma_plan``, ``block_tiles`` and
# ``group_tiles`` in kernels/flash_attention.py, the rule of
# ``launch_wg_dt`` in csrc/flash_attention.cu), with the mode it must pick:
# (H, S, T, D, causal, window, sms, mode)
WGMMA_PLANS = [
    (32, 47, 47, 128, True, None, 132, "rows"),       # the serve prefill
    (16, 47, 47, 64, True, 16, 132, "rows"),          # windowed
    (4, 64, 64, 128, True, None, 132, "rows"),        # one whole tile
    (4, 65, 65, 128, True, None, 132, "split"),       # a row past it
    (32, 2047, 2047, 128, True, None, 132, "rows"),   # the long prompt
    (8, 512, 512, 64, True, None, 132, "split"),      # kernel_bench
    (8, 513, 513, 64, True, None, 132, "split"),
    (4, 100, 100, 80, True, 33, 132, "split"),
    (8, 130, 300, 64, True, None, 132, "split"),      # S < T
    (8, 300, 130, 64, True, 50, 132, "split"),        # rows past every key
    (8, 300, 300, 256, True, 128, 132, "rows"),       # one group at D = 256
    (32, 1100, 1100, 256, True, 1024, 132, "rows"),   # gemma3's window
    (2, 40, 40, 16, False, None, 132, "rows"),
    (4, 200, 200, 64, False, 64, 4, "rows"),          # non-causal, windowed
    (4, 200, 90, 64, False, None, 132, "split"),
]


@pytest.mark.parametrize("H,S,T,D,causal,window,sms,mode", WGMMA_PLANS)
def test_wgmma_plan_covers_every_visible_pair_once(H, S, T, D, causal, window, sms, mode):
    """Over the blocks of the plan, the warpgroups' rows and key tiles
    compute every visible (query, key) pair exactly once and no pair twice,
    every tile a block loads and every tile a group computes holds a pair
    its rows see, and a group computes only tiles its block loaded."""
    from repro_torch.kernels.flash_attention import block_tiles, group_tiles, wgmma_plan

    plan = wgmma_plan(1, H, S, T, D, sms)
    assert plan.mode == mode
    BK = plan.keys
    qp, kp = np.arange(S)[:, None], np.arange(T)[None, :]
    vis = np.ones((S, T), dtype=bool)
    if causal:
        vis &= kp <= qp
    if window is not None:
        vis &= kp > qp - window
    count = np.zeros((S, T), dtype=np.int64)

    def sees(rows, u):
        return bool(vis[rows.start:rows.stop, u * BK:(u + 1) * BK].any())

    for q0 in range(0, S, plan.rows):
        loaded = list(block_tiles(plan, q0, S, T, causal, window))
        assert all(sees(range(q0, min(q0 + plan.rows, S)), u) for u in loaded)
        for wg in range(plan.warpgroups):
            rows, tiles = group_tiles(plan, q0, wg, S, T, causal, window)
            assert set(tiles) <= set(loaded)
            assert all(sees(rows, u) for u in tiles)
            for u in tiles:
                count[rows.start:rows.stop, u * BK:(u + 1) * BK] += 1
    assert (count[vis] == 1).all()
    assert count.max() <= 1


# --------------------------------------------------------------------- #
def assert_router_equal(got, want):
    for g, w, name in zip(got, want, ("probs", "vals")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].dtype == torch.int32


@pytest.mark.parametrize("T,E,k", [(64, 16, 2), (100, 64, 6), (7, 8, 2)])
def test_router_topk(T, E, k):
    """The cases of ``tests/test_kernels.py:144`` against the Pallas kernel
    in interpret mode (its block of 32 tokens pads T=100 and T=7)."""
    logits = np.random.default_rng(T + E).standard_normal((T, E)).astype(np.float32)
    want = jax_router(jnp.asarray(logits), k, block_tokens=32, interpret=True)
    assert_router_equal(ops.router_topk(torch.from_numpy(logits), k), want)


def test_router_topk_ties_go_to_the_lower_index():
    """Rows with exactly equal logits: the lower expert wins each tie, as
    the TPU kernel's iterated argmax and ``lax.top_k`` choose."""
    logits = np.zeros((4, 16), np.float32)
    logits[1, [3, 9, 12]] = 2.0  # three-way tie for the top
    logits[2, [15, 0]] = 1.0
    logits[3] = np.arange(16) % 4  # four ties of four
    want = jax_router(jnp.asarray(logits), 3, block_tokens=32, interpret=True)
    got = ops.router_topk(torch.from_numpy(logits), 3)
    assert_router_equal(got, want)
    assert got[2].tolist() == [[0, 1, 2], [3, 9, 12], [0, 15, 1], [3, 7, 11]]


@pytest.mark.parametrize("op", ["paged_attention", "page_gather", "page_scatter",
                                "router_topk", "flash_attention", "moe_route",
                                "moe_dispatch", "moe_combine"])
def test_kernel_impl_on_cpu_raises(op):
    """``impl="kernel"`` on a CPU tensor raises; it never falls back."""
    x = torch.zeros((4, 2, 8, 16))
    frames = torch.zeros(2, dtype=torch.int32)
    calls = {
        "paged_attention": lambda: ops.paged_attention(
            torch.zeros((1, 4, 16)), x, x, torch.zeros((1, 2), dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), impl="kernel"),
        "page_gather": lambda: ops.page_gather(x, frames, impl="kernel"),
        "page_scatter": lambda: ops.page_scatter(x, frames, x[:2], impl="kernel"),
        "router_topk": lambda: ops.router_topk(torch.zeros((3, 16)), 2, impl="kernel"),
        "flash_attention": lambda: ops.flash_attention(x, x, x, impl="kernel"),
        "moe_route": lambda: ops.moe_route(torch.zeros((3, 8)), torch.zeros((8, 16)), 2, 1,
                                           impl="kernel"),
        "moe_dispatch": lambda: ops.moe_dispatch(
            torch.zeros((3, 8)), torch.full((16,), -1, dtype=torch.int32), 16, 1,
            impl="kernel"),
        "moe_combine": lambda: ops.moe_combine(
            torch.zeros((16, 1, 8)), torch.zeros(6, dtype=torch.int32),
            torch.zeros((3, 2)), impl="kernel"),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[op]()


@pytest.mark.parametrize("op", ["page_gather", "page_scatter"])
@pytest.mark.parametrize("fault", ["frame_size", "base_address"])
def test_copy_kernels_refuse_misaligned_frames(op, fault):
    """The copy kernels move 16-byte vectors; a 12-byte frame or a store
    that starts 4 bytes into an allocation is refused, not copied."""
    store = (torch.zeros((4, 3)) if fault == "frame_size"
             else torch.zeros(17)[1:].view(4, 4))
    frames = torch.zeros(2, dtype=torch.int32)
    call = {"page_gather": lambda: page_migrate.page_gather(store, frames),
            "page_scatter": lambda: page_migrate.page_scatter(store, frames,
                                                              store[:2])}[op]
    with pytest.raises(ValueError, match="16-byte aligned"):
        call()


@pytest.mark.parametrize("op", ["page_gather", "page_scatter"])
@pytest.mark.parametrize("fault", ["frames_on_a_device", "frames_int64", "frames_2d",
                                   "frame_out_of_range", "stores_differ", "three_stores"])
def test_copy_kernels_refuse_bad_frames_or_stores(op, fault):
    """The kernels read frame indices on the host (a 1-D int32 CPU
    tensor, each in ``[0, F)``) and copy one store or a matching pair."""
    store = torch.zeros((4, 8))
    frames = {"frames_on_a_device": torch.zeros(2, dtype=torch.int32, device="meta"),
              "frames_int64": torch.zeros(2, dtype=torch.int64),
              "frames_2d": torch.zeros((1, 2), dtype=torch.int32),
              "frame_out_of_range": torch.tensor([1, 4], dtype=torch.int32)
              }.get(fault, torch.zeros(2, dtype=torch.int32))
    stores = {"stores_differ": (store, torch.zeros((4, 8), dtype=torch.float64)),
              "three_stores": (store, store, store)}.get(fault, store)
    match = {"frames_on_a_device": "CPU tensor", "frames_int64": "1-D int32",
             "frames_2d": "1-D int32", "frame_out_of_range": r"outside \[0, 4\)",
             "stores_differ": "stores differ", "three_stores": "1 to 2 stores"}[fault]
    pages = torch.zeros((2, 8)) if isinstance(stores, torch.Tensor) else torch.zeros((2, 2, 8))
    call = {"page_gather": lambda: page_migrate.page_gather(stores, frames),
            "page_scatter": lambda: page_migrate.page_scatter(stores, frames, pages)}[op]
    with pytest.raises(ValueError, match=match):
        call()


# --------------------------------------------------------------------- #
# The paged kernel's split over pages (flash-decoding): each split of
# the block table gives (m, l, acc) per query head, and the last block
# of each (sequence, head) combines them.  The algebra, in plain torch.
def split_partials(q, kp, vp, bt, valid, scale, NS, pps):
    """Per-split ``m, l (B, H, NS)`` and ``acc (B, H, NS, D)``, the
    kernel's guards: a split with no valid slot gives m = -inf, l = 0,
    acc = 0."""
    B, H, D = q.shape
    _, Hkv, P, _ = kp.shape
    MP = bt.shape[1]
    kg = kp[bt.long()].movedim(2, 1).reshape(B, Hkv, MP * P, D)
    vg = vp[bt.long()].movedim(2, 1).reshape(B, Hkv, MP * P, D)
    s = torch.einsum("bhgd,bhtd->bhgt", q.reshape(B, Hkv, H // Hkv, D) * scale, kg)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    ms, ls, accs = [], [], []
    for sp in range(NS):
        lo, hi = sp * pps * P, min(MP, (sp + 1) * pps) * P
        ss = s[..., lo:hi]
        m = ss.max(dim=-1).values
        m_safe = torch.where(m == float("-inf"), torch.zeros_like(m), m)
        p = torch.where(ss == float("-inf"), torch.zeros_like(ss),
                        torch.exp(ss - m_safe[..., None]))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhgt,bhtd->bhgd", p, vg[:, :, lo:hi]))
    return (torch.stack(ms, -1).reshape(B, H, NS), torch.stack(ls, -1).reshape(B, H, NS),
            torch.stack(accs, -2).reshape(B, H, NS, D))


def combine_splits(m, l, acc):
    """Rescale each split to the row's maximum and sum: a split at
    m = -inf weighs 0, and l is clamped at 1e-20, so a row whose splits
    are all masked gives exactly 0."""
    M = m.max(dim=-1, keepdim=True).values
    w = torch.where(m == float("-inf"), torch.zeros_like(m), torch.exp(m - M))
    return (w[..., None] * acc).sum(-2) / (w * l).sum(-1).clamp_min(1e-20)[..., None]


@pytest.mark.parametrize("NS", [1, 2, 3, 8])
@pytest.mark.parametrize("case", ["pad_pages", "window", "pad_lane", "length"])
def test_paged_attention_split_combine(case, NS):
    """Splits of the (B, MP=8) block table, combined, equal the plain
    version and JAX's ``paged_attention_ref`` (``repro/kernels/ref.py:40``):
    with whole splits masked by pad pages or by a window, with a lane
    whose every entry is a pad page (exact zeros), and in length mode."""
    B, H, Hkv, P, MP, D, F = 3, 8, 2, 4, 8, 16, 20
    rng, q, kp, vp, bt = attn_inputs(NS * 7 + len(case), B, H, Hkv, P, MP, D, F,
                                     "float32")
    pps = -(-MP // NS)
    NS = -(-MP // pps)  # NS = 3 → runs of 3, 3, 2 pages
    kw_t, kw_j = {}, {}
    if case == "length":
        lengths = np.asarray([5, 32, 17], np.int32)
        valid = torch.arange(MP * P)[None, :] < torch.from_numpy(lengths)[:, None].long()
        kw_j["lengths"], kw_t["lengths"] = ints(lengths)
    else:
        page_pos = np.tile(np.arange(MP, dtype=np.int32) * P, (B, 1))
        q_pos = np.full(B, MP * P - 2, np.int32)
        window = 9 if case == "window" else None  # masks pages 0-4 whole
        if case == "pad_pages":
            page_pos[:, 4:] = PAD_PAGE_POS  # the last half of every lane
        if case == "pad_lane":
            page_pos[2] = PAD_PAGE_POS
            q_pos[2] = 0
        pos = torch.from_numpy(page_pos).long()[:, :, None] + torch.arange(P)
        qp = torch.from_numpy(q_pos).long()[:, None, None]
        valid = pos <= qp
        if window is not None:
            valid &= pos > qp - window
        valid = valid.reshape(B, MP * P)
        kw_j["page_pos"], kw_t["page_pos"] = ints(page_pos)
        kw_j["q_pos"], kw_t["q_pos"] = ints(q_pos)
        kw_j["window"] = kw_t["window"] = window
    m, l, acc = split_partials(q[1], kp[1], vp[1], bt[1], valid, 1.0 / math.sqrt(D),
                               NS, pps)
    if case in ("pad_pages", "window") and NS > 1:
        assert (m == float("-inf")).any(), "no split was masked whole"
    got = combine_splits(m, l, acc)
    want_t = ops.paged_attention(q[1], kp[1], vp[1], bt[1], **kw_t)
    want_j = paged_attention_ref(q[0], kp[0], vp[0], bt[0], **kw_j)
    assert torch.isfinite(got).all()
    assert_close(got, want_t.numpy(), "float32")
    assert_close(got, want_j, "float32")
    if case == "pad_lane":
        assert (got[2] == 0).all()


@pytest.mark.parametrize("B,Hkv,G,MP", [
    (8, 4, 8, 8),    # tinyllama-1.1b decode: 8 splits of one page
    (8, 8, 4, 8),    # phi3.5-moe decode
    (8, 4, 8, 64),   # long context
    (3, 2, 20, 6),   # G > 16: two blocks per KV head
    (33, 4, 8, 8),   # B·Hkv = 132, one block per SM: no split
    (64, 4, 8, 8),   # B·Hkv = 256
    (1, 1, 1, 1), (2, 1, 4, 0),
])
def test_paged_attention_split_plan_covers_every_page_once(B, Hkv, G, MP):
    sms = 132
    GC, NW, NS, pps = split_plan(B, Hkv, G, MP, sms)
    assert GC * NW >= G and NW <= 16 and (GC - 1) * NW < G
    runs = [range(s * pps, min(MP, (s + 1) * pps)) for s in range(NS)]
    assert sorted(i for r in runs for i in r) == list(range(MP))
    assert all(len(r) > 0 for r in runs) or MP == 0
    if B * Hkv * GC >= sms or MP <= 1:
        assert NS == 1
    else:
        assert 1 < NS <= MP
    if (B, Hkv, MP) == (8, 4, 8):
        assert (NS, pps) == (8, 1)


# --------------------------------------------------------------------- #
# The fused route's grid (route_plan) and its split of the capacity
# dispatch over token tiles: each tile's last block ranks the tile's
# assignments per expert (8 warps, each a run of 32-assignment chunks,
# and a scan over warps), the grid's last block scans the tiles' counts
# into bases, and a second launch places each tile's assignments at
# base + rank.  Held here against the plain version's stable-argsort
# slots.
# --------------------------------------------------------------------- #
ROUTE_SHAPES = [(8, 4096, 16, 2), (47, 4096, 16, 2), (4096, 2048, 64, 6), (5, 64, 4, 2),
                (1, 32, 1, 1), (300, 100, 256, 8), (1023, 33, 8, 2), (2000, 130, 6, 3),
                (20000, 2048, 64, 6)]  # past 16,384 tokens: 313 tiles


@pytest.mark.parametrize("T,d,E,k", ROUTE_SHAPES)
def test_route_plan_covers_tokens_and_width(T, d, E, k):
    p = rt.route_plan(T, d, E, 132)
    NE, NM, KS, TM, NT, NC, DC, BK = (p[n] for n in ("NE", "NM", "KS", "TM", "NT", "NC",
                                                      "DC", "BK"))
    assert NE * NM * KS == rt.THREADS and NM <= 16 and TM == 4 * NM
    assert NE & (NE - 1) == 0 and NM & (NM - 1) == 0
    assert E <= 4 * NE <= rt.MAX_EXPERTS
    assert NT == -(-T // TM)
    # a k-tile fits the staging registers: 2 and 8 float4 of x and w a thread
    assert BK % rt.BK_MIN == 0 and TM * BK <= 2048 and BK * 4 * NE <= 8192
    assert DC % BK == 0 and (NC - 1) * DC < d <= NC * DC  # no empty chunk
    assert NC <= rt.MAX_CHUNKS and (NT * NC <= 2 * 132 or NC == 1)



# The MoE dispatch's and combine's grids (glue_plan): (rows, vectors a
# row, k), k None for the dispatch.  phi3.5-moe's and deepseek-v2-lite's
# decode, deepseek's T=4096, the dispatch's backward at phi3.5's T=2048,
# the element path (d=4094), ragged tiles and the combine's largest k.
GLUE_SHAPES = [(16, 1024, None), (8, 1024, 2), (64, 512, None), (2, 512, 6), (8, 512, 6),
               (30720, 512, None), (4096, 512, 6), (2048, 1024, 2), (3, 4094, 8),
               (37, 10, 2), (600, 1025, 2), (5, 64, 12), (1, 1, 1), (1, 10, 6144)]


@pytest.mark.parametrize("rows,n,k", GLUE_SHAPES)
def test_glue_plan_covers_rows_and_vectors(rows, n, k):
    sms = 132
    p = (md.glue_plan(rows, n, sms) if k is None else md.combine_plan(rows, n, k, sms))
    bx, by, vpt, (gx, gy) = p["bx"], p["by"], p["vpt"], p["grid"]
    assert bx & (bx - 1) == 0 and 1 <= by <= rows and bx * by <= md.THREADS
    big = rows * n >= 2 * sms * md.RESIDENT  # two waves of resident threads
    assert vpt == (4 if k is not None and k <= 2 and big else 1)
    cols = -(-n // vpt)
    assert (gx - 1) * by < rows <= gx * by  # every row, no empty tile
    assert (gy - 1) * bx < cols <= gy * bx and gy <= 65535
    if k is not None:  # the tile's slots and gates fit the staging buffer
        assert by * k * 8 <= md.STAGE_BYTES
    # the grid spreads over the card: at least a block an SM, or every
    # block holds at least 32 threads' work
    assert gx * gy >= min(sms, -(-rows * cols // 256))
    if (rows, n, k) == (2, 512, 6):  # deepseek's decode combine: 32 warps
        assert (bx, by, gx, gy) == (32, 1, 2, 16)
    if (rows, n, k) == (64, 512, None):  # its dispatch: 512 blocks of 64
        assert (bx, by, gx, gy) == (64, 1, 64, 8)

def tile_ranked_slots(idx, TM, E, C, warps=8):
    """The kernel's placement over ``idx (T, k)`` in numpy: each tile's
    ranks (its last block), the grid's last block's scan of the tiles'
    counts, (E, NT), into each tile's bases (a warp an expert, 128 tiles
    a round: four warp-wide prefixes and a carry), then each tile's own
    placement at base + rank (the second launch, a block a tile)."""
    T, k = idx.shape
    NT = -(-T // TM)
    rank = np.empty(T * k, np.int64)
    tcnt = np.zeros((E, NT), np.int64)
    for tile in range(NT):
        ids = idx[tile * TM:(tile + 1) * TM].reshape(-1)
        n = ids.size
        seg = -(-n // (warps * 32)) * 32
        wc = np.zeros((warps, E), np.int64)
        for w in range(warps):  # counts of each warp's run
            lo, hi = min(n, w * seg), min(n, w * seg + seg)
            wc[w] = np.bincount(ids[lo:hi], minlength=E)
        tcnt[:, tile] = wc.sum(axis=0)
        wc = np.cumsum(wc, axis=0) - wc  # exclusive scan over warps
        for w in range(warps):
            lo, hi = min(n, w * seg), min(n, w * seg + seg)
            for base in range(lo, hi, 32):  # a chunk: rank among lower peers
                e = ids[base:min(hi, base + 32)]
                lower = (e[None, :] == e[:, None]) & np.tri(e.size, k=-1, dtype=bool)
                rank[tile * TM * k + base + np.arange(e.size)] = wc[w, e] + lower.sum(axis=1)
                wc[w] += np.bincount(e, minlength=E)
    bases = np.empty_like(tcnt)
    counts = np.empty(E, np.int64)
    for e in range(E):  # the grid's last block: a warp an expert
        carry = 0
        for q0 in range(0, NT, 128):
            q = q0 + np.arange(128).reshape(4, 32)
            c = np.where(q < NT, tcnt[e, np.minimum(q, NT - 1)], 0)
            inc = np.cumsum(c, axis=1)  # four warp-wide inclusive prefixes
            for j in range(4):
                live = q[j] < NT
                bases[e, q[j][live]] = (carry + inc[j] - c[j])[live]
                carry += inc[j, 31]
        counts[e] = carry
    slot = np.empty(T * k, np.int64)
    src = np.full(E * C, -1, np.int64)
    for tile in range(NT):  # the placement: each tile its own assignments
        i = np.arange(tile * TM * k, min(T, (tile + 1) * TM) * k)
        e = idx.reshape(-1)[i]
        pos = rank[i] + bases[e, tile]
        slot[i] = np.where(pos < C, e * C + pos, E * C)
        keep = pos < C
        src[slot[i][keep]] = i[keep] // k
    return slot, src, counts


@pytest.mark.parametrize("T,d,E,k", ROUTE_SHAPES)
@pytest.mark.parametrize("factor", [1.25, 8.0])
def test_route_tiles_give_the_plain_slots(T, d, E, k, factor):
    rng = np.random.default_rng(T + E)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    logits[T // 2:] = logits[T // 2]  # identical rows pile onto the same experts
    C = max(1, int(factor * T * k / E))
    r = rt.route_logits_plain(torch.from_numpy(logits), k, C)
    slot, src, counts = tile_ranked_slots(r.idx.numpy(), rt.route_plan(T, d, E, 132)["TM"],
                                          E, C)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.src.numpy(), src)
    np.testing.assert_array_equal(r.counts.numpy(), counts)


@pytest.mark.parametrize("fault", ["widths", "k", "capacity", "assignments"])
def test_moe_route_refuses_what_the_kernel_does_not_take(fault):
    """Checked before the device: the plain version refuses the same."""
    x, w, k, C = torch.zeros((4, 8)), torch.zeros((8, 16)), 2, 1
    if fault == "widths":
        w = torch.zeros((7, 16))
    elif fault == "k":
        k = 9
    elif fault == "capacity":
        C = 0
    else:
        C = rt.MAX_ASSIGNMENTS
    for fn in (rt.moe_route, rt.moe_route_plain):
        with pytest.raises(ValueError, match="moe_route"):
            fn(x, w, k, C)
