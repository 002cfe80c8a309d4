"""The output check fails when the timed path is broken underneath, and
its control (the program's bfloat16 path) comes out not correct."""

import time

import pytest

from repro_torch.serving import ServingEngine, TieredKVCache

from portbench.harness import spec
from portbench.harness.cell import run_cell
from portbench.tests.smoke import make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # prompts of 7-13 pages: top-4 of the older pages is a real choice
    return make_root(tmp_path_factory.mktemp("smoke"), prompt_len=(100, 200),
                     output_len=(20, 40))


_step = ServingEngine._batched_step_impl


def token_altered(self, *a):
    """A token altered where it is produced (lane 0 of every step)."""
    t = _step(self, *a)
    t[0] = (t[0] + 1) % self.cfg.vocab
    return t


def copies_dropped(self):
    """The tiers' copies dropped: pages move in the pool, not in the store."""
    self._pending, self._pending_src, self._pending_dst = [], set(), set()


def pages_misselected(self, seq, scores):
    """The oldest pages attended instead of the top-k by relevance."""
    n, r, k = len(seq.pages), self.ecfg.recent_pages, self.ecfg.topk_pages
    return seq.pages[:min(k, max(0, n - r))] + seq.pages[max(0, n - r):]


FAULTS = {"token": (ServingEngine, "_batched_step_impl", token_altered),
          "copies": (TieredKVCache, "flush_migrations", copies_dropped),
          "selection": (ServingEngine, "_select_pages", pages_misselected)}


def _run(root, cell, seconds=1.5, **kw):
    c = spec.load_cell(cell, root)
    return run_cell(c, 7, seconds, False, "cpu", time.perf_counter(), time.perf_counter, **kw)


@pytest.mark.parametrize("cell", ["phi3-medium-14b.decode-tiered", "phi3.5-moe-8l.decode-tiered"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    sound = _run(root, cell)
    assert sound["correct"], sound["check"]
    monkeypatch.setattr(*FAULTS[fault])
    out = _run(root, cell)
    assert not out["correct"]
    assert out["check"]["widest_gap"]["value"] > out["check"]["widest_gap"]["limit"]


@pytest.mark.parametrize("cell", ["phi3-medium-14b.decode-tiered", "phi3.5-moe-8l.decode-tiered"])
def test_bfloat16_control_is_not_correct(root, cell):
    import torch

    # long enough that several requests finish: at 1.5 s a sample of two
    # short ones can hold no token where bfloat16 picks another
    out = _run(root, cell, seconds=3.0, dtype=torch.bfloat16)
    assert not out["correct"]
    assert out["check"]["widest_gap"]["value"] > out["check"]["widest_gap"]["limit"]
