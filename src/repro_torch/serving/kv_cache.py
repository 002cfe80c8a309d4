"""Two-tier paged KV cache — the serving-side embodiment of TPP.

Counterpart of ``repro/serving/kv_cache.py`` over torch stores:

* **page**   = ``page_size`` tokens × all attention layers of one
  sequence (the migration unit).
* **frame space** — one global frame index range split by tier: frames
  ``[0, num_fast)`` are the fast tier, ``[num_fast, num_fast+num_slow)``
  the slow tier, and one extra **trash frame** at the end absorbs the
  padded lanes of batched writes and copies.
* **payload layout** — split K/V stores ``(F, L, Hkv, P, D)``:
  frame-major, so one ``page_gather``/``page_scatter`` moves a whole page
  across tiers, and the per-layer view ``store[:, li]`` feeds
  ``kernels.paged_attention`` in place.
* The :class:`~repro_torch.core.PagePool` is the metadata manager: the
  engine reports touches, TPP decides migrations, this class executes
  the payload copies.

One policy interval's copies are staged and executed as one
``page_gather``→``page_scatter`` pair per direction and store at the
next payload access, all gathers before any scatter (the JAX cache's
``staged_migration=True``; its eager per-page copies belong to the
reference data plane, not ported yet).  Both run on the current CUDA
stream in program order, which is what makes the gathers-first order
hold on the card.  The stores are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import PagePool, PageType, Tier, TppConfig
from repro_torch.kernels import ops as kernel_ops


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
        # One shared staged-copy width, sized from the policy budgets (an
        # interval batch cannot exceed them).  The prewarm builds and
        # loads the copy kernels before the first flush on the serving
        # path needs them.
        self._flush_width = bucket(max(self.pool.config.demote_budget,
                                       self.pool.config.promote_budget, 1))
        idx = self._frames([self.trash_frame] * self._flush_width)
        kernel_ops.page_scatter(
            self.k_store, idx, kernel_ops.page_gather(self.k_store, idx))
        kernel_ops.page_scatter(
            self.v_store, idx, kernel_ops.page_gather(self.v_store, idx))

    def _frames(self, frames: Sequence[int]) -> torch.Tensor:
        """Host frame list → int32 index tensor on the store's device."""
        return torch.from_numpy(np.asarray(frames, np.int32)).to(self.device)

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
        """PagePool hook: stage one page's copy between tiers."""
        src_g = self._global(src, src_frame)
        dst_g = self._global(dst, dst_frame)
        self.migrated_pages += 1
        self.migrated_bytes += self.cfg.page_bytes
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
        """Execute the staged interval batch: one ``page_gather`` →
        ``page_scatter`` per direction per store.

        All gathers run before any scatter, so a frame freed by a
        demotion and immediately reclaimed by a promotion (or vice
        versa) still sources the pre-interval payload.
        """
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        self._pending_src, self._pending_dst = set(), set()
        # pad every batch to one shared power-of-two width via the trash
        # frame (a self-copy of garbage)
        self._flush_width = max(self._flush_width, bucket(max(
            sum(c.demote for c in pending),
            sum(not c.demote for c in pending),
        )))
        batches = []  # (dst_frames, staged_k, staged_v) — gather phase
        for demote in (True, False):
            group = [c for c in pending if c.demote == demote]
            if not group:
                continue
            pad = [self.trash_frame] * (self._flush_width - len(group))
            src = self._frames([c.src for c in group] + pad)
            dst = self._frames([c.dst for c in group] + pad)
            batches.append((
                dst,
                kernel_ops.page_gather(self.k_store, src),
                kernel_ops.page_gather(self.v_store, src),
            ))
        for dst, staged_k, staged_v in batches:  # scatter phase
            kernel_ops.page_scatter(self.k_store, dst, staged_k)
            kernel_ops.page_scatter(self.v_store, dst, staged_v)

    def _flush_if_touches(self, gframe: int) -> None:
        if self._pending and (
            gframe in self._pending_src or gframe in self._pending_dst
        ):
            self.flush_migrations()

    # ---------------------------------------------------------------- #
    # payload plumbing
    # ---------------------------------------------------------------- #
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
