"""Bytes and FLOPs counted from shapes, against hand counts at a smoke
shape: d=64, 4 heads of 16, 2 KV heads, 2 layers, vocab 256."""

import pytest

from portbench.harness import work

DENSE = work.Shapes(d=64, heads=4, kv_heads=2, head_dim=16, layers=2, vocab=256, d_ff=128,
                    page_size=16)
MOE = work.Shapes(d=64, heads=4, kv_heads=2, head_dim=16, layers=2, vocab=256, experts=4,
                  top_k=2, d_ff_expert=128, page_size=16)


@pytest.mark.parametrize("pos,want", [
    (5, 5 + 1),              # one partial page, itself
    (32, 32 + 1),            # two full pages are the recent ones
    (100, 4 * 16 + (100 - 5 * 16) + 1),  # 7 pages: 5 older, top-4 of them
    (200, 4 * 16 + (200 - 11 * 16) + 1),  # 13 pages: 11 older
])
def test_attended_tokens(pos, want):
    assert work.attended_tokens(pos, 16, 4, 2) == want


def test_decode_step_work_dense():
    positions = [5, 100]
    A = 6 + 85
    layer = 2 * 64 * (64 + 2 * 32) + 2 * 64 * 64 + 6 * 64 * 128
    want = 2 * 2 * layer + 2 * 4 * 64 * A + 2 * 2 * 64 * 256
    w = work.decode_step_work(DENSE, positions, 4, 2)
    assert w["flops"] == want
    assert w["pa_bytes"] == 2 * (A * 2 * 2 * 16 * 4 + 2 * 2 * 64 * 4)


def test_moe_counts_the_routed_experts_only():
    layer = 2 * 64 * (64 + 2 * 32) + 2 * 64 * 64 + 2 * 64 * 4 + 2 * 6 * 64 * 128
    assert MOE.layer_matmul_flops() == layer


def test_flash_and_prefill():
    fw = work.flash_work(DENSE, 10)
    assert fw["flops"] == 4 * 16 * 4 * 55
    assert fw["bytes"] == (2 * 10 * 64 + 2 * 10 * 32) * 4
    pw = work.prefill_work(DENSE, 11)
    assert pw["flops"] == 10 * 2 * DENSE.layer_matmul_flops() + 2 * fw["flops"]
    assert pw["flash_bound_s"] == pytest.approx(2 * max(fw["bytes"] / 3.35e12, fw["flops"] / 67e12))
    assert work.prefill_work(DENSE, 1)["flops"] == 0.0


def test_shapes_of_configs():
    from portbench.harness import spec

    c = spec.load_cell("phi3.5-moe-8l.decode-tiered").config
    s = work.Shapes.of(c, 16)
    assert (s.experts, s.top_k, s.d_ff_expert, s.d_ff) == (16, 2, 6400, 0)
    c = spec.load_cell("phi3-medium-14b.decode-tiered").config
    s = work.Shapes.of(c, 16)
    assert (s.experts, s.d_ff, s.layers) == (0, 17920, 40)
