"""The traffic generator: the same seed gives the same requests, another
seed other ones over the same sizes."""

import collections

import numpy as np
import pytest

from portbench.harness import spec, traffic
from portbench.harness.traffic import ClosedTraffic, arrival_offsets, open_requests

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _sig(reqs):
    return [(r.index, tuple(r.prompt), r.max_new, r.due) for r in reqs]


def _requests(cell, seed):
    c = spec.load_cell(cell)
    w, vocab = c.workload, c.config["vocab_size"]
    if w["loop"] == "closed":
        t = ClosedTraffic(w, seed, vocab)
        return t.snapshot + [t.refill(i) for i in range(40)]
    return open_requests(w, seed, vocab, 30.0)


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_traffic_other_seed_other(cell):
    big = 2**31 + 977
    assert _sig(_requests(cell, big)) == _sig(_requests(cell, big))
    assert _sig(_requests(cell, big)) != _sig(_requests(cell, big + 1))


@pytest.mark.parametrize("cell", [c for c in CELLS if "decode" in c])
def test_closed_seeds_share_sizes(cell):
    """Every seed sends the same sizes in the same order, its own tokens;
    each refill block holds the block's grid."""
    c = spec.load_cell(cell)
    w = c.workload
    a, b = ClosedTraffic(w, 1, 50), ClosedTraffic(w, 2, 50)
    assert len(a.snapshot) == len(b.snapshot) == w["lanes"]
    blk = w["block"]
    for t0 in (0, blk, 5 * blk):
        ra = [a.refill(i) for i in range(t0, t0 + blk)]
        rb = [b.refill(i) for i in range(t0, t0 + blk)]
        assert sorted(len(r.prompt) for r in ra) == sorted(len(r.prompt) for r in rb)
        assert [r.max_new for r in ra] == [r.max_new for r in rb]
        assert [r.prompt for r in ra] != [r.prompt for r in rb]
    assert [len(r.prompt) for r in a.snapshot] == [len(r.prompt) for r in b.snapshot]
    lo, hi = w["prompt_len"]
    assert all(lo <= len(a.refill(i).prompt) <= hi for i in range(64))


def test_snapshot_carries_part_of_its_output():
    c = spec.load_cell("phi3-medium-14b.decode-tiered")
    w = c.workload
    t = ClosedTraffic(w, 5, 1000)
    olo, ohi = w["output_len"]
    # prompt + remaining output never pass the longest context
    assert all(len(r.prompt) + r.max_new <= w["prompt_len"][1] + ohi for r in t.snapshot)
    assert any(len(r.prompt) > w["prompt_len"][1] for r in t.snapshot)
    assert all(r.max_new >= 1 for r in t.snapshot)


def test_open_loop_offers_the_stated_rate_on_one_schedule():
    c = spec.load_cell("phi3.5-moe-8l.chat-open")
    w, rate = c.workload, c.workload["arrivals"]["mean_rate"]
    due = arrival_offsets(w["arrivals"], 50.0)
    assert len(due) == round(rate * 50.0)
    assert np.all(np.diff(due) >= 0) and due[0] >= 0 and due[-1] < 50.0
    a, b = open_requests(w, 11, 100, 50.0), open_requests(w, 12, 100, 50.0)
    assert [(r.due, len(r.prompt), r.max_new) for r in a] == [
        (r.due, len(r.prompt), r.max_new) for r in b]
    assert [r.prompt for r in a] != [r.prompt for r in b]
    # bursty: some seconds hold several arrivals, others none
    per_s = collections.Counter(int(t) for t in due)
    assert max(per_s.values()) >= 3 and len(per_s) < 50


def test_loguniform_grid_spans_the_range():
    g = traffic.loguniform_grid(64, 512, 16)
    assert g[0] >= 64 and g[-1] <= 512 and list(g) == sorted(g)
    assert abs(np.log(g).mean() - np.log(np.sqrt(64 * 512))) < 0.05
