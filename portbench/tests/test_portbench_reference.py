"""The reference's handling of ties: a flipped route takes the next expert,
a prompt with a few tied routes is judged on every way of resolving them,
and one with more is set aside."""

import json

import pytest
import torch

from portbench.harness.loops import Driver
from portbench.harness.traffic import Req
from portbench.harness.weights import make_params, plain_layers, port_config
from portbench.reference import model
from portbench.tests.smoke import make_root


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The smoke MoE configuration, its reference, and three requests the
    engine served to the end (no clock in the loop)."""
    from repro_torch.core import TppConfig
    from repro_torch.serving import EngineConfig, ServingEngine

    root = make_root(tmp_path_factory.mktemp("smoke"))
    config = json.loads((root / "portbench" / "configs" / "phi3.5-moe-8l.json").read_text())
    cfg = port_config(config)
    params = make_params(cfg, 5, torch.device("cpu"))
    ecfg = EngineConfig(page_size=16, topk_pages=4, recent_pages=2, policy="tpp",
                        tpp=TppConfig(), max_seqs=3, data_plane="batched",
                        num_fast=64, num_slow=64)
    drv = Driver(ServingEngine(cfg, params, ecfg, seed=5, device=torch.device("cpu")))
    gen = torch.Generator().manual_seed(5)
    for i, n in enumerate((40, 70, 100)):
        drv.admit(Req(index=i, prompt=torch.randint(0, 256, (n,), generator=gen).tolist(),
                      max_new=12))
    while drv.active():
        drv.step()
    requests = [(drv.reqs[i].prompt, drv.served[i]) for i in range(3)]
    return model.Model(config, plain_layers(params, cfg.n_layers)), requests


def _judge(ref, requests):
    return model.judge(ref, requests, 16, 4, 2, torch.device("cpu"))


def test_a_flipped_route_takes_the_next_expert(served):
    ref, _ = served
    lay = ref.w["layers"][0]
    h = torch.randn(5, ref.d, generator=torch.Generator().manual_seed(1))
    flip = torch.tensor([False, True, False, True, False])
    probs = torch.softmax(h @ lay["router"], dim=-1)
    order = probs.argsort(dim=-1, descending=True)
    want = torch.zeros_like(h)
    for t in range(5):
        experts = [order[t, 0], order[t, 2] if flip[t] else order[t, 1]]
        gates = probs[t, experts] / probs[t, experts].sum()
        for e, g in zip(experts, gates):
            a = torch.nn.functional.silu(h[t] @ lay["e_gate"][e]) * (h[t] @ lay["e_up"][e])
            want[t] += g * (a @ lay["e_down"][e])
    for dense in (False, True):
        y, _ = ref.ffn(lay, h, dense_experts=dense, flip=flip)
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)


def test_tied_prompt_routes_are_followed_on_every_way(served, monkeypatch):
    ref, requests = served
    assert _judge(ref, requests)["widest_gap"] == 0.0
    # routes whose margin is under 1% count as tied (two in each prompt
    # here): the engine took one way of each, and the branch that follows
    # it reads what it served
    monkeypatch.setattr(model, "AMBIGUOUS", 0.01)
    seq = torch.tensor(requests[2][0][:-1])
    branches = model._prefill_branches(ref, seq, 128, torch.device("cpu"))
    assert 2 <= len(branches) <= 2 ** model.MAX_FOLLOWED
    assert any(not torch.equal(branches[0][0], b[0]) for b in branches[1:])
    out = _judge(ref, requests)
    assert out["prompt_ties_followed"] >= 1
    assert out["widest_gap"] == 0.0 and out["judged_tokens"] > 0
    # a token altered where it was served still fails on every branch
    bad = [(p, s[:3] + [(s[3] + 1) % 256] + s[4:]) for p, s in requests]
    assert _judge(ref, bad)["widest_gap"] > 0.0


def test_a_prompt_with_more_tied_routes_is_set_aside(served, monkeypatch):
    ref, requests = served
    monkeypatch.setattr(model, "AMBIGUOUS", 10.0)  # every route ties
    out = _judge(ref, requests)
    assert out["tied_in_prompt"] == 3 and out["judged_tokens"] == 0
    assert out["set_aside_tokens"] == out["served_tokens"]
