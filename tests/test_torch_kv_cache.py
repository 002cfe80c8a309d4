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
from repro.serving.kv_cache import KVCacheConfig as JCfg  # noqa: E402
from repro.serving.kv_cache import TieredKVCache as JCache  # noqa: E402
from repro_torch.core import PageType, TppConfig  # noqa: E402
from repro_torch.serving.kv_cache import KVCacheConfig, TieredKVCache  # noqa: E402

KW = dict(n_layers=2, page_size=4, n_kv_heads=2, head_dim=8, num_fast=6,
          num_slow=8)


class Pair:
    """The two caches driven in lockstep."""

    def __init__(self):
        self.j = JCache(JCfg(**KW, staged_migration=True),
                        tpp=JTppConfig(demote_budget=4, promote_budget=2))
        self.t = TieredKVCache(KVCacheConfig(**KW),
                               tpp=TppConfig(demote_budget=4, promote_budget=2),
                               device="cpu")
        self.rng = np.random.default_rng(0)

    def alloc(self):
        a = self.j.alloc_page(JPageType.ANON, tenant=0)
        b = self.t.alloc_page(PageType.ANON, tenant=0)
        assert a == b
        return a

    def write(self, pids, slots):
        L, Hkv, D = KW["n_layers"], KW["n_kv_heads"], KW["head_dim"]
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


def test_staged_migration_script_matches_jax_cache_bit_for_bit():
    c = Pair()
    assert c.t._flush_width == c.j._flush_width == 4
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
    # reads settle the batch; the padded flush width stays 4
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

