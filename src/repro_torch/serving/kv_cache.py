"""Two-tier paged KV cache — the serving-side embodiment of TPP.

Counterpart of ``repro/serving/kv_cache.py`` over torch stores:

* **page**   = ``page_size`` tokens × all attention layers of one
  sequence (the migration unit).
* **frame space** — one global frame index range split by tier: frames
  ``[0, num_fast)`` are the fast tier, ``[num_fast, num_fast+num_slow)``
  the slow tier, and one extra **trash frame** at the end absorbs the
  padded lanes of batched writes and block tables.
* **payload layout** — split K/V stores ``(F, L, Hkv, P, D)``:
  frame-major, so one ``page_gather``/``page_scatter`` moves a whole page
  across tiers, and the per-layer view ``store[:, li]`` feeds
  ``kernels.paged_attention`` in place.
* The :class:`~repro_torch.core.PagePool` is the metadata manager: the
  engine reports touches, TPP decides migrations, this class executes
  the payload copies.

With ``staged_migration=True`` (the batched data plane, and the port's
default) one policy interval's copies are staged and executed at the
next payload access as one ``page_gather`` over both stores (K and V)
into one staging tensor, then one ``page_scatter`` of it back,
demotions first in the frame list.  The gather runs before the scatter,
on the current CUDA stream in program order, which keeps a frame freed
by a demotion and claimed by a promotion in the same interval correct.
The stores are updated in place.  The frame list holds only the live
copies: the JAX cache pads every batch with trash-frame self-copies to
a power-of-two width so that its jit-compiled copies keep one shape,
but a CUDA kernel has no shape-specialised compile, so the port moves
no padding.  The frame indices stay on the host and reach the kernel by
value.

With ``staged_migration=False`` (the reference data plane; the JAX
cache's default) every migration copies its page eagerly with a plain
indexed assignment of K and V, as the JAX cache's ``.at[].set`` does:
no copy kernel is built or launched.  Both produce identical payloads.

``TIERSAN_PLAN_CHECK=1`` verifies every flushed batch for frame hazards
under the gathers-first staging the kernels execute and keeps the last
plan (``last_plan``, :mod:`repro_torch.analysis.plan_verify`).
"""

from __future__ import annotations

import dataclasses
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.plan_verify import CopyOp, check_plan, plan_from_staged
from repro_torch.core import PagePool, PageType, Tier, TppConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.spans import span


def _host_frames(frames: Sequence[int]) -> torch.Tensor:
    """A frame list as the 1-D int32 CPU tensor the copy kernels read."""
    return torch.from_numpy(np.asarray(frames, np.int32))


def bucket(n: int) -> int:
    """Next power of two ≥ n — pads batch shapes to a few stable sizes."""
    b = 1
    while b < n:
        b <<= 1
    return b


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    n_layers: int
    page_size: int  # tokens per page
    n_kv_heads: int
    head_dim: int
    num_fast: int  # frames in the fast tier
    num_slow: int
    dtype: str = "float32"
    # Batch one policy interval's payload copies into one staged gather
    # and scatter (the batched data plane); False copies eagerly per page
    # (the reference plane).  The JAX cache defaults to False.
    staged_migration: bool = True

    @property
    def kv_width(self) -> int:
        """Per-token-per-layer elements: k‖v packed (2·Hkv·D)."""
        return 2 * self.n_kv_heads * self.head_dim

    @property
    def page_bytes(self) -> int:
        itemsize = torch.empty((), dtype=getattr(torch, self.dtype)).element_size()
        return self.n_layers * self.page_size * self.kv_width * itemsize


@dataclasses.dataclass
class _StagedCopy:
    pid: int
    src: int  # global frame
    dst: int  # global frame
    demote: bool  # fast→slow


class TieredKVCache:
    """Physical two-tier paged KV store + logical page table."""

    def __init__(self, cfg: KVCacheConfig, tpp: Optional[TppConfig] = None,
                 device="cuda") -> None:
        self.cfg = cfg
        self.device = torch.device(device)
        dt = getattr(torch, cfg.dtype)
        self.num_slow = max(cfg.num_slow, 1)
        # +1 trash frame: padded lanes of batched writes land there.
        total = cfg.num_fast + self.num_slow + 1
        self.trash_frame = total - 1
        shape = (total, cfg.n_layers, cfg.n_kv_heads, cfg.page_size, cfg.head_dim)
        self.k_store = torch.zeros(shape, dtype=dt, device=self.device)
        self.v_store = torch.zeros(shape, dtype=dt, device=self.device)
        self.pool = PagePool(
            cfg.num_fast, cfg.num_slow, config=tpp,
            on_migrate=self._on_migrate, on_evict=self._cancel_pending,
        )
        self.migrated_pages = 0
        self.migrated_bytes = 0
        self._pending: List[_StagedCopy] = []
        self._pending_src: set = set()
        self._pending_dst: set = set()
        #: flushes that moved pages, and a histogram of the pairs each moved
        self.flushes = 0
        self.flush_pairs: Counter = Counter()
        # Debug-build plan verification (TIERSAN_PLAN_CHECK=1): every
        # flushed batch is checked for frame hazards under the
        # gathers-first staging the kernels execute, and the last plan is
        # kept for offline triage.
        self.plan_check = (
            os.environ.get("TIERSAN_PLAN_CHECK", "") not in ("", "0")
        )
        self.last_plan: Optional[List[CopyOp]] = None
        if cfg.staged_migration:
            # Build and load the copy kernels before the first flush on
            # the serving path needs them: a one-frame trash self-copy.
            idx = _host_frames([self.trash_frame])
            stores = (self.k_store, self.v_store)
            kernel_ops.page_scatter(stores, idx, kernel_ops.page_gather(stores, idx))

    def _frames(self, frames: Sequence[int]) -> torch.Tensor:
        """Host frame list → int32 index tensor on the store's device."""
        return _host_frames(frames).to(self.device)

    # ---------------------------------------------------------------- #
    # frame addressing
    # ---------------------------------------------------------------- #
    def _global(self, tier: Tier, frame: int) -> int:
        return frame if tier == Tier.FAST else self.cfg.num_fast + frame

    def global_frame(self, pid: int) -> int:
        """Global frame index of a page (fast tier first, then slow)."""
        page = self.pool.pages[pid]
        return self._global(page.tier, page.frame)

    def global_frames(self, pids: Sequence[int]) -> np.ndarray:
        return np.fromiter(
            (self.global_frame(int(p)) for p in pids), np.int32, count=len(pids)
        )

    # ---------------------------------------------------------------- #
    # migration data plane
    # ---------------------------------------------------------------- #
    def _on_migrate(self, pid: int, src: Tier, src_frame: int, dst: Tier,
                    dst_frame: int) -> None:
        """PagePool hook: copy (or stage) one page between tiers."""
        src_g = self._global(src, src_frame)
        dst_g = self._global(dst, dst_frame)
        self.migrated_pages += 1
        self.migrated_bytes += self.cfg.page_bytes
        if not self.cfg.staged_migration:
            self.k_store[dst_g] = self.k_store[src_g]
            self.v_store[dst_g] = self.v_store[src_g]
            return
        if src_g in self._pending_dst:
            # chained move (the page migrated earlier this interval and
            # its payload has not landed yet) — settle the batch first.
            self.flush_migrations()
        self._pending.append(
            _StagedCopy(pid=pid, src=src_g, dst=dst_g, demote=(src == Tier.FAST))
        )
        self._pending_src.add(src_g)
        self._pending_dst.add(dst_g)

    def _cancel_pending(self, pid: int) -> None:
        """Drop staged copies of a page that is being freed/evicted."""
        if not self._pending:
            return
        self._pending = [c for c in self._pending if c.pid != pid]
        self._pending_src = {c.src for c in self._pending}
        self._pending_dst = {c.dst for c in self._pending}

    def flush_migrations(self) -> None:
        """Execute the staged interval batch: one ``page_gather`` of the
        live source frames of both stores, then one ``page_scatter`` of
        the staging into the target frames, demotions first.

        All gathers run before any scatter, so a frame freed by a
        demotion and immediately reclaimed by a promotion (or vice
        versa) still sources the pre-interval payload.  Target frames
        within a flush are distinct: a frame staged as a target is
        occupied until the flush, and a page leaving it settles the
        batch first (:meth:`_on_migrate`).
        """
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        self._pending_src, self._pending_dst = set(), set()
        if self.plan_check:
            self.last_plan = plan_from_staged(pending)
            check_plan(
                self.last_plan,
                num_frames=self.trash_frame + 1,
                trash_frame=self.trash_frame,
                staging="gathers-first",
            )
        order = ([c for c in pending if c.demote]
                 + [c for c in pending if not c.demote])
        stores = (self.k_store, self.v_store)
        with span("kv.flush"):
            staged = kernel_ops.page_gather(stores, _host_frames([c.src for c in order]))
            kernel_ops.page_scatter(stores, _host_frames([c.dst for c in order]), staged)
        self.flushes += 1
        self.flush_pairs[len(order)] += 1

    def _flush_if_touches(self, gframe: int) -> None:
        if self._pending and (
            gframe in self._pending_src or gframe in self._pending_dst
        ):
            self.flush_migrations()

    # ---------------------------------------------------------------- #
    # payload plumbing
    # ---------------------------------------------------------------- #
    def write_token(self, pid: int, slot: int, kv: torch.Tensor) -> None:
        """Write one token's KV ``(L, W)``, laid out ``[all-k | all-v]``,
        into page ``pid`` at ``slot``."""
        gf = self.global_frame(pid)
        self._flush_if_touches(gf)
        L, Hkv, D = self.cfg.n_layers, self.cfg.n_kv_heads, self.cfg.head_dim
        self.k_store[gf, :, :, slot, :] = kv[:, : Hkv * D].reshape(L, Hkv, D)
        self.v_store[gf, :, :, slot, :] = kv[:, Hkv * D:].reshape(L, Hkv, D)

    def write_tokens(self, pids: Sequence[int], slots: Sequence[int],
                     k_tok: torch.Tensor, v_tok: torch.Tensor) -> None:
        """Batched token write: ``k_tok``/``v_tok`` are ``(T, L, Hkv, D)``
        landing at ``(pids[i], slots[i])`` — one scatter per store."""
        if not len(pids):
            return
        self.flush_migrations()
        gf = self._frames(self.global_frames(pids)).long()
        sl = self._frames(slots).long()
        self.k_store[gf, :, :, sl, :] = k_tok.to(self.k_store.dtype)
        self.v_store[gf, :, :, sl, :] = v_tok.to(self.v_store.dtype)

    def gather_pages(self, pids: List[int]) -> torch.Tensor:
        """Gather page payloads → packed ``(n, L, P, W)``; reads cross
        tiers in place (the global frame space)."""
        n = len(pids)
        L, P = self.cfg.n_layers, self.cfg.page_size
        if not n:
            return torch.zeros((0, L, P, self.cfg.kv_width),
                               dtype=self.k_store.dtype, device=self.device)
        self.flush_migrations()
        gf = self._frames(self.global_frames(pids)).long()
        k = self.k_store[gf].movedim(2, 3).reshape(n, L, P, -1)
        v = self.v_store[gf].movedim(2, 3).reshape(n, L, P, -1)
        return torch.cat([k, v], dim=-1)

    # ---------------------------------------------------------------- #
    # allocation API (used by the engine)
    # ---------------------------------------------------------------- #
    def alloc_page(
        self, page_type: PageType = PageType.ANON,
        tenant: Optional[int] = None,
    ) -> int:
        """Allocate a KV page; ``tenant`` tags the frame for the tiering
        control plane (−1 = untracked)."""
        page = self.pool.allocate(
            page_type, tenant=-1 if tenant is None else tenant
        )
        # The claimed frame may still source a staged copy (it was freed
        # by a not-yet-flushed demotion): settle before anyone writes it.
        self._flush_if_touches(self._global(page.tier, page.frame))
        return page.pid

    def free_page(self, pid: int) -> None:
        self._cancel_pending(pid)
        self.pool.free(pid)

    def retype(self, pid: int, page_type: PageType) -> None:
        """Reclassify a page (e.g. ANON tail → FILE prefix when sealed)."""
        page = self.pool.pages[pid]
        if page.page_type != page_type:
            node = self.pool.lru[page.tier]
            node.discard(pid, page.page_type)
            page.page_type = page_type
            node.insert(pid, page_type, page.active)

    def occupancy(self) -> Dict[str, int]:
        return self.pool.occupancy()

    # ---------------------------------------------------------------- #
    # residency introspection
    # ---------------------------------------------------------------- #
    def tiers_of(self, pids: Sequence[int]) -> np.ndarray:
        """Tier of each live page (``Tier`` values as an int array)."""
        return np.fromiter(
            (int(self.pool.tier_of(int(p))) for p in pids),
            np.int64, count=len(pids),
        )

    def fast_fraction(self, pids: Sequence[int]) -> float:
        """Fraction of the given pages resident in the fast tier (empty
        page lists read as fully fast)."""
        if not len(pids):
            return 1.0
        fast = int((self.tiers_of(pids) == int(Tier.FAST)).sum())
        return fast / len(pids)
