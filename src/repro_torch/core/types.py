"""Core types for the tiered-memory subsystem.

Terminology maps 1:1 onto the paper (TPP, §5):

* ``Tier.FAST``  — CPU-local DRAM in the paper; HBM on TPU.
* ``Tier.SLOW``  — CXL-Memory in the paper; host DRAM on TPU.
* ``PageType.ANON`` — anonymous pages (stack/heap/mmap) in the paper;
  decode-active KV pages / activations here.
* ``PageType.FILE`` — file-backed page cache in the paper; prefix/history
  KV pages, paused sequences, cold MoE experts here.

A *logical page* is a stable id used by block tables; it maps to a
``(tier, frame)`` pair.  Migration re-homes a logical page to a frame on the
other tier and copies the payload — block tables never change on migration,
which is exactly the paper's "transparent" property (virtual addresses are
stable under NUMA migration).
"""

from __future__ import annotations

import dataclasses
import enum


class Tier(enum.IntEnum):
    """Memory tiers.  Values are array indices — do not reorder."""

    FAST = 0  # local DRAM / HBM
    SLOW = 1  # CXL-Memory / host DRAM

    # Sentinel for a logical page with no backing frame.
    NONE = 2


class PageType(enum.IntEnum):
    """Page classes with distinct temperature behaviour (paper §3.3)."""

    ANON = 0  # hot-leaning: request processing, short-lived
    FILE = 1  # cold-leaning: caches, long-lived


class PageFlags(enum.IntFlag):
    """Per-page flag bits (mirrors the paper's use of page->flags).

    ``DEMOTED`` is the paper's ``PG_demoted`` (0x40) used to count
    ping-pong: set on demotion, cleared on promotion; a page that is a
    promotion candidate *while* DEMOTED is a ping-pong event (§5.5).
    """

    NONE = 0
    ACTIVE = 1  # on the active LRU list
    ACCESSED = 2  # referenced since last scan (PG_referenced analogue)
    DEMOTED = 4  # PG_demoted
    UNEVICTABLE = 8  # pinned (e.g. recurrent SSM state, hugepage pools)


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """Static description of one memory tier."""

    name: str
    num_frames: int
    # Modeled access-cost multiplier relative to FAST (paper Fig. 2: CXL
    # adds ~50-100ns over ~100ns DRAM → 1.5-2.0x; PCIe host tier is worse).
    access_cost: float
    # Migration bandwidth cap, pages/step (paper §7: 1-4K pages/s steady).
    migrate_budget: int


@dataclasses.dataclass(frozen=True)
class TppConfig:
    """Tunables of the TPP policy (paper §5.1-§5.4).

    Watermarks are expressed as *free-frame fractions* of the fast tier,
    matching the kernel's zone-watermark formulation:

    * ``wm_min``        — hard floor; allocations below this fail to FAST
      and overflow to SLOW (kernel ``min_watermark``).
    * ``wm_alloc``      — 'allocation can happen' level (kernel ``low``).
    * ``wm_demote``     — background demotion keeps reclaiming until free
      frames reach this level (the *decoupled*, higher watermark of §5.2;
      kernel patch: ``demote_scale_factor``, default 2%).
    """

    wm_min: float = 0.005
    wm_alloc: float = 0.01
    wm_demote: float = 0.02  # demote_scale_factor default (§5.2)

    # Promotion hysteresis (§5.3): require the faulted page to be on the
    # active LRU before promoting (2-touch filter).  Disable to get the
    # instant-promotion behaviour of default NUMA Balancing.
    active_lru_filter: bool = True

    # Fraction of slow-tier hits sampled into the promotion path per step
    # (NUMA-hint-fault sampling; default NUMA Balancing samples 256MB/s —
    # we express it as a probability over touched slow pages).
    sample_rate: float = 1.0

    # Per-step migration budgets (pages).  Demotion is asynchronous and
    # cheap (paper: migration ≫ faster than swap) but still rate-limited.
    demote_budget: int = 64
    promote_budget: int = 32

    # §5.4 page-type-aware allocation: FILE pages prefer the slow tier.
    file_to_slow: bool = False

    # Decouple allocation from reclamation (§5.2).  When False, demotion
    # only triggers on allocation failure (the tightly-coupled behaviour
    # the paper ablates in Fig. 17).
    decoupled: bool = True

    def frames(self, num_fast: int) -> tuple[int, int, int]:
        """Watermarks in frames: (min, alloc, demote)."""
        lo = max(1, int(self.wm_min * num_fast))
        al = max(lo + 1, int(self.wm_alloc * num_fast))
        de = max(al + 1, int(self.wm_demote * num_fast))
        return lo, al, de

    def frames_for_budget(
        self, num_fast: int, budget: int
    ) -> tuple[int, int, int]:
        """Watermarks enforcing a fast-tier *budget* < physical capacity.

        A fleet coordinator pushes a host's share of the global fast-tier
        budget down as a watermark update: the ``num_fast - budget``
        frames beyond the budget are reserved (always kept free), and the
        usual min/alloc/demote fractions apply to the budgeted capacity.
        Background reclaim then parks free frames at
        ``reserved + frames(budget).demote``, so the pool's *effective*
        fast tier is exactly ``budget`` frames; ``budget == num_fast``
        reproduces :meth:`frames` bit-for-bit (no reservation).
        """
        if not 4 <= budget <= num_fast:
            raise ValueError(
                f"fast budget {budget} outside [4, {num_fast}] "
                "(watermarks need >= 4 budgeted frames)"
            )
        reserved = num_fast - budget
        lo, al, de = self.frames(budget)
        return lo + reserved, al + reserved, de + reserved


# Failure reasons for promotion attempts (§5.5 observability).
class PromoteFail(enum.IntEnum):
    NONE = 0
    TARGET_LOW_MEM = 1  # fast tier has no free frame even ignoring wm
    NOT_ACTIVE = 2  # filtered by the active-LRU hysteresis
    BUDGET = 3  # per-step promotion budget exhausted
    PINNED = 4  # unevictable page
    QOS = 5  # denied by the multi-tenant arbiter (quota / token bucket)


class DemoteFail(enum.IntEnum):
    NONE = 0
    SLOW_FULL = 1  # no free frame on the slow tier (fall back: evict)
    BUDGET = 2
    PINNED = 3
