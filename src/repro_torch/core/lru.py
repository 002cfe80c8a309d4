"""Active/inactive LRU lists, per tier and per page type.

Mirrors the kernel structure TPP builds on (paper §4 "Page Temperature
Detection": *"we find Linux's existing LRU-based age management mechanism
is lightweight and quite efficient"*):

* Each tier (NUMA node) owns **four** lists: {anon,file} × {active,inactive}.
* ``mark_accessed`` implements the kernel's two-touch activation: an
  inactive page that is referenced twice is moved to the active list.
  TPP's promotion hysteresis (§5.3) piggybacks on exactly this.
* Reclaim scans the **tail** (oldest end) of the inactive lists with a
  second-chance pass: referenced pages rotate back, unreferenced pages are
  reclaim candidates.
* ``age_active`` is the kernel's active→inactive balancing: when the
  inactive list falls below the target ratio, cold active pages are
  deactivated (their ACCESSED bit is the age test).

The implementation is an ``OrderedDict`` per list — O(1) add / remove /
rotate — with the MRU end on the *right*.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterator, List, Optional, Tuple

from repro_torch.core.types import PageType, Tier


class LruList:
    """One LRU list. Right end = most recently added (head), left = oldest."""

    __slots__ = ("_d",)

    def __init__(self) -> None:
        self._d: "OrderedDict[int, None]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, pid: int) -> bool:
        return pid in self._d

    def add_head(self, pid: int) -> None:
        """Insert at the MRU end."""
        self._d[pid] = None
        self._d.move_to_end(pid, last=True)

    def add_tail(self, pid: int) -> None:
        """Insert at the oldest end (used for second-chance rotation)."""
        self._d[pid] = None
        self._d.move_to_end(pid, last=False)

    def remove(self, pid: int) -> None:
        del self._d[pid]

    def discard(self, pid: int) -> bool:
        if pid in self._d:
            del self._d[pid]
            return True
        return False

    def pop_oldest(self) -> Optional[int]:
        if not self._d:
            return None
        pid, _ = self._d.popitem(last=False)
        return pid

    def peek_oldest(self) -> Optional[int]:
        if not self._d:
            return None
        return next(iter(self._d))

    def rotate(self, pid: int) -> None:
        """Move an existing page to the MRU end."""
        self._d.move_to_end(pid, last=True)

    def iter_oldest(self) -> Iterator[int]:
        """Iterate oldest→newest over a snapshot (safe to mutate inside)."""
        return iter(list(self._d.keys()))

    def clear(self) -> None:
        self._d.clear()


class NodeLru:
    """The four LRU lists of one memory tier (NUMA node)."""

    def __init__(self, tier: Tier) -> None:
        self.tier = tier
        # [page_type][active] -> LruList
        self.lists: List[List[LruList]] = [
            [LruList(), LruList()] for _ in PageType
        ]

    def list_for(self, page_type: PageType, active: bool) -> LruList:
        return self.lists[int(page_type)][int(active)]

    def insert(self, pid: int, page_type: PageType, active: bool) -> None:
        self.list_for(page_type, active).add_head(pid)

    def remove(self, pid: int, page_type: PageType, active: bool) -> None:
        self.list_for(page_type, active).remove(pid)

    def discard(self, pid: int, page_type: PageType) -> None:
        self.lists[int(page_type)][0].discard(pid)
        self.lists[int(page_type)][1].discard(pid)

    def n_active(self, page_type: PageType) -> int:
        return len(self.lists[int(page_type)][1])

    def n_inactive(self, page_type: PageType) -> int:
        return len(self.lists[int(page_type)][0])

    def counts(self) -> Tuple[int, int]:
        """(total inactive, total active) across page types."""
        inact = sum(len(self.lists[int(t)][0]) for t in PageType)
        act = sum(len(self.lists[int(t)][1]) for t in PageType)
        return inact, act
