"""The port's tiered KV cache against ``repro.serving.kv_cache``.

One alloc / write / migrate / flush script runs through the JAX
``TieredKVCache(staged_migration=True)`` and the port's: it includes
frame swaps in one staged batch (a promotion lands in the fast frame a
demotion freed, and a demotion lands in the slow frame that promotion
freed, so only the gathers-first flush keeps the payloads), a chained
move (a page migrates again before its first copy landed), a
free that cancels a staged copy, and the prewarmed padded flush width.
The stores must match bit for bit after every phase.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import PageType as JPageType, TppConfig as JTppConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serving.kv_cache import KVCacheConfig as JCfg  # noqa: E402
from repro.serving.kv_cache import TieredKVCache as JCache  # noqa: E402
from repro_torch.core import PageType, Tier, TppConfig  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.page_migrate import MAX_PAIRS  # noqa: E402
from repro_torch.serving.kv_cache import KVCacheConfig, TieredKVCache  # noqa: E402

KW = dict(n_layers=2, page_size=4, n_kv_heads=2, head_dim=8, num_fast=6,
          num_slow=8)


class Pair:
    """The two caches driven in lockstep; every copy call each makes is
    recorded, with its frame list as a host list."""

    def __init__(self, monkeypatch, kw=KW, demote_budget=4, promote_budget=2):
        self.kw = kw
        self.calls = {"jax": [], "torch": []}
        for side, mod in (("jax", jops), ("torch", tops)):
            for op in ("page_gather", "page_scatter"):
                monkeypatch.setattr(mod, op, self._spy(side, op, getattr(mod, op)))
        self.j = JCache(JCfg(**kw, staged_migration=True),
                        tpp=JTppConfig(demote_budget=demote_budget,
                                       promote_budget=promote_budget))
        self.t = TieredKVCache(KVCacheConfig(**kw),
                               tpp=TppConfig(demote_budget=demote_budget,
                                             promote_budget=promote_budget),
                               device="cpu")
        self.rng = np.random.default_rng(0)

    def _spy(self, side, op, fn):
        def spy(stores, frames, *rest, **kwargs):
            if side == "torch":
                assert frames.device.type == "cpu" and frames.dtype == torch.int32
                n_stores = 1 if isinstance(stores, torch.Tensor) else len(stores)
            else:
                n_stores = 1
            self.calls[side].append((op, np.asarray(frames).tolist(), n_stores))
            return fn(stores, frames, *rest, **kwargs)
        return spy

    def check_copies(self):
        """The port made one gather and one scatter over both stores per
        flush (plus the prewarm's one-frame trash self-copy), each
        with exactly the live frames the JAX cache copied, in its order
        (demotions first), none of its trash padding; no kernel ran."""
        trash = self.t.trash_frame
        calls = self.calls["torch"]
        assert [op for op, _, _ in calls] == \
            ["page_gather", "page_scatter"] * (1 + self.t.flushes)
        assert all(n == 2 for _, _, n in calls)
        assert calls[0][1] == calls[1][1] == [trash]  # the prewarm
        flushes = [(g[1], s[1]) for g, s in zip(calls[2::2], calls[3::2])]
        for src, dst in flushes:
            assert len(src) == len(dst) > 0 and trash not in src + dst
            assert len(set(dst)) == len(dst), "targets within a flush are distinct"
        assert sorted(self.t.flush_pairs.elements()) == sorted(len(s) for s, _ in flushes)
        # the JAX cache, after its prewarm (gather, scatter of K, then of
        # V): per direction a gather of K then of V with the same frames,
        # then the scatters in the same order
        for k, op in enumerate(("page_gather", "page_scatter")):
            jax_k = [frames for o, frames, _ in self.calls["jax"][4:] if o == op][::2]
            assert [f for pair in flushes for f in pair[k]] == \
                [f for frames in jax_k for f in frames if f != trash]
        assert not any(tops.launch_counts().values()), "no kernel runs on the CPU"

    def alloc(self):
        a = self.j.alloc_page(JPageType.ANON, tenant=0)
        b = self.t.alloc_page(PageType.ANON, tenant=0)
        assert a == b
        return a

    def write(self, pids, slots):
        L, Hkv, D = self.kw["n_layers"], self.kw["n_kv_heads"], self.kw["head_dim"]
        k = self.rng.standard_normal((len(pids), L, Hkv, D)).astype(np.float32)
        v = self.rng.standard_normal((len(pids), L, Hkv, D)).astype(np.float32)
        self.j.write_tokens(pids, slots, jnp.asarray(k), jnp.asarray(v))
        self.t.write_tokens(pids, slots, torch.from_numpy(k), torch.from_numpy(v))

    def both(self, fn):
        return fn(self.j), fn(self.t)

    def check(self, phase):
        for name in ("k_store", "v_store"):
            np.testing.assert_array_equal(
                getattr(self.t, name).numpy(), np.asarray(getattr(self.j, name)),
                err_msg=f"{name} after {phase}")
        assert self.t.global_frames(list(self.t.pool.pages)).tolist() == \
            self.j.global_frames(list(self.j.pool.pages)).tolist(), phase
        assert self.t.migrated_bytes == self.j.migrated_bytes, phase


def test_staged_migration_script_matches_jax_cache_bit_for_bit(monkeypatch):
    c = Pair(monkeypatch)
    pids = [c.alloc() for _ in range(5)]  # fast frames 0..4
    c.write([p for p in pids for _ in range(4)], [s for _ in pids for s in range(4)])
    c.check("prefill")
    # fill the fast tier so the next allocation overflows to slow
    pids.append(c.alloc())
    slow_pid = c.alloc()
    c.write([pids[5], slow_pid], [0, 0])
    c.check("overflow")
    # demote→promote frame swap: the promotion claims the fast frame the
    # demotion freed ...
    freed_fast = c.t.global_frame(pids[1])
    c.both(lambda k: k.pool.demote_page(pids[1]))
    c.both(lambda k: k.pool.promote_page(slow_pid))
    assert c.t.global_frame(slow_pid) == freed_fast
    # ... and a demotion claims the slow frame the promotion freed.  The
    # flush runs demotions first, so only the gathers-first order keeps
    # the promoted page's payload.
    c.both(lambda k: k.pool.demote_page(pids[2]))
    assert [(p.src, p.dst) for p in c.t._pending] == \
        [(p.src, p.dst) for p in c.j._pending]
    assert c.t._pending[2].dst == c.t._pending[1].src
    c.check("frame swaps staged")
    # chained move: pids[1] moves again while its first copy is staged
    c.both(lambda k: k.pool.promote_page(pids[1]))
    c.check("chained move")
    # a staged copy of a freed page is cancelled
    c.both(lambda k: k.pool.demote_page(pids[3]))
    c.both(lambda k: k.free_page(pids[3]))
    assert [p.pid for p in c.t._pending] == [p.pid for p in c.j._pending]
    assert pids[3] not in [p.pid for p in c.t._pending] and c.t._pending
    c.check("cancel")
    # reads settle the batch
    got = c.t.gather_pages([slow_pid, pids[1], pids[0]])
    want = c.j.gather_pages([slow_pid, pids[1], pids[0]])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    c.check("gather_pages")
    for _ in range(3):
        p = c.alloc()
        c.write([p], [0])
    c.both(lambda k: k.flush_migrations())
    c.check("final flush")
    c.both(lambda k: k.pool.check_invariants())
    assert c.t.migrated_pages == c.j.migrated_pages > 2
    c.check_copies()
    assert c.t.flushes >= 2


def test_staged_flush_over_one_launch_matches_jax_cache(monkeypatch):
    """An interval stages more copies than one copy launch carries by
    value (the kernel wrapper splits such a list into launches): small
    frames, every fast page demoted and slow pages promoted into the
    freed frames, still bit for bit and one gather and scatter."""
    kw = dict(n_layers=1, page_size=2, n_kv_heads=1, head_dim=4,
              num_fast=MAX_PAIRS + 40, num_slow=MAX_PAIRS + 80)
    c = Pair(monkeypatch, kw=kw, demote_budget=MAX_PAIRS + 40, promote_budget=16)
    pids = [c.alloc() for _ in range(MAX_PAIRS + 48)]
    c.write(pids, [1] * len(pids))
    c.check("prefill")
    fast = [p for p in pids if c.t.pool.tier_of(p) == Tier.FAST]
    slow = [p for p in pids if c.t.pool.tier_of(p) != Tier.FAST]
    assert len(fast) > MAX_PAIRS and slow
    for p in fast:
        c.both(lambda k: k.pool.demote_page(p))
    for p in slow[:8]:
        c.both(lambda k: k.pool.promote_page(p))
    assert len(c.t._pending) == len(fast) + min(8, len(slow)) > MAX_PAIRS
    c.check("staged")
    c.both(lambda k: k.flush_migrations())
    c.check("flush")
    c.check_copies()
    assert c.t.flushes == 1 and c.t.flush_pairs == {len(fast) + min(8, len(slow)): 1}

