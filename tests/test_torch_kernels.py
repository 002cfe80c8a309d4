"""The port's kernel modules against the JAX package's Pallas kernels.

Each plain PyTorch version (what a CPU tensor runs) is held against the
Pallas TPU kernel in interpret mode, as ``tests/test_kernels.py`` runs
it, on that file's sweeps and tolerances (``TOL``: 2e-5 in float32,
2e-2 in bfloat16; gather and scatter exact).  Inputs are made with numpy
from a seed and handed to both frameworks.  The CUDA kernels themselves
run only on the card (``chip_smoke.py``).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.page_migrate import page_gather as jax_gather  # noqa: E402
from repro.kernels.page_migrate import page_scatter as jax_scatter  # noqa: E402
from repro.kernels.paged_attention import paged_attention as jax_paged  # noqa: E402
from repro_torch.kernels import ops, page_migrate  # noqa: E402
from repro_torch.kernels.paged_attention import PAD_PAGE_POS  # noqa: E402

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
@pytest.mark.parametrize(
    "n,f,seed",
    [(1, 8, 0), (4, 16, 7), (8, 24, 42), (3, 12, 100), (2, 9, 55),
     (6, 20, 13), (8, 8, 77), (5, 23, 31)],
)
def test_page_migrate_round_trip(n, f, seed):
    """gather∘scatter round-trips arbitrary frames, exactly as Pallas does."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((f, 2, 4, 8)).astype(np.float32)
    idx = rng.choice(f, size=n, replace=False).astype(np.int32)
    g_jax = jax_gather(jnp.asarray(src), jnp.asarray(idx), interpret=True)
    g = ops.page_gather(torch.from_numpy(src), torch.from_numpy(idx))
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_jax))
    dst = np.zeros_like(src)
    s_jax = jax_scatter(jnp.asarray(dst), jnp.asarray(idx), g_jax, interpret=True)
    dst_t = torch.from_numpy(dst.copy())
    s = ops.page_scatter(dst_t, torch.from_numpy(idx), g)
    assert s.data_ptr() == dst_t.data_ptr(), "page_scatter writes in place"
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_jax))


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


@pytest.mark.parametrize("op", ["paged_attention", "page_gather", "page_scatter"])
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
