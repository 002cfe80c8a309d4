"""Chameleon — lightweight user-space memory characterization (paper §3).

The paper's Chameleon samples LLC-miss loads via PEBS at 1/200, rotates
sampling across core groups every ``mini_interval`` (5 s), double-buffers
samples into hash tables, and a Worker thread folds each interval into a
per-page **64-bit access bitmap** (bit set ⇔ page touched that interval;
left-shifted each interval).  From the bitmaps it derives the paper's
figures: hot/warm/cold fractions (Fig. 7), per-page-type temperature
(Fig. 8), usage over time (Fig. 9) and re-access intervals (Fig. 11).

Here the "PEBS events" are the access streams the harness already sees
(page ids touched per step).  We keep the same pipeline shape —
Collector (sampling, double buffer) → Worker (bitmap fold, stats) — so the
profiler's overhead/accuracy trade-off (sample_rate, duty_cycle) is a real
knob with the same semantics as the paper's.

A copy of ``repro.core.chameleon`` with the same behaviour; the port keeps its own
so that it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
import random
from collections import defaultdict
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.types import PageType

HISTORY_BITS = 64


def _popcount(x: int) -> int:
    return bin(x).count("1")


@dataclasses.dataclass
class PageStats:
    page_type: PageType
    bitmap: int = 0  # bit0 = most recent *closed* interval
    first_seen: int = 0
    samples: int = 0


@dataclasses.dataclass
class IntervalSummary:
    """Per-interval aggregate (one row of the paper's time-series figures)."""

    interval: int
    touched: Dict[PageType, int]
    resident: Dict[PageType, int]
    samples: int


class Chameleon:
    """Collector + Worker, as one object driven by the harness clock.

    Parameters
    ----------
    sample_rate:
        Probability an access event is recorded (paper default 1/200).
    duty_cycle:
        Fraction of "core groups" sampled per mini-interval; rotating
        groups in the paper ≈ sampling only ``duty_cycle`` of the event
        stream here.
    """

    def __init__(
        self,
        sample_rate: float = 1.0 / 200.0,
        duty_cycle: float = 1.0,
        seed: int = 0,
    ) -> None:
        self.sample_rate = sample_rate
        self.duty_cycle = duty_cycle
        self._rng = random.Random(seed)
        self._pages: Dict[int, PageStats] = {}
        # Double buffer: current interval's touched set (the "hash table"
        # the Collector fills while the Worker reads the other one).
        self._current_touched: set = set()
        self._interval = 0
        self._summaries: List[IntervalSummary] = []
        self._interval_samples = 0
        # re-access bookkeeping: page -> interval of last access
        self._last_access: Dict[int, int] = {}
        self._reaccess_gaps: List[int] = []
        self._group_phase = 0.0

    # ---------------------------------------------------------------- #
    # Collector
    # ---------------------------------------------------------------- #
    def record(self, accesses: Iterable[Tuple[int, PageType]]) -> None:
        """Feed access events (pid, page_type) — the PEBS sample stream."""
        # Duty cycling: advance the core-group rotation; a slice of events
        # is visible this mini-interval.
        for pid, ptype in accesses:
            self._group_phase += self.duty_cycle
            if self._group_phase < 1.0:
                continue
            self._group_phase -= 1.0
            if self.sample_rate < 1.0 and self._rng.random() >= self.sample_rate:
                continue
            self._interval_samples += 1
            st = self._pages.get(pid)
            if st is None:
                st = PageStats(page_type=ptype, first_seen=self._interval)
                self._pages[pid] = st
            st.samples += 1
            if pid not in self._current_touched:
                self._current_touched.add(pid)
                last = self._last_access.get(pid)
                if last is not None and self._interval > last:
                    self._reaccess_gaps.append(self._interval - last)
                self._last_access[pid] = self._interval

    def note_free(self, pid: int) -> None:
        """Page freed — stop tracking (virtual-space mode of the Worker)."""
        self._pages.pop(pid, None)
        self._last_access.pop(pid, None)
        self._current_touched.discard(pid)

    # ---------------------------------------------------------------- #
    # Worker
    # ---------------------------------------------------------------- #
    def end_interval(self, resident: Optional[Mapping[PageType, int]] = None) -> IntervalSummary:
        """Close the interval: fold the touched set into the bitmaps."""
        touched_by_type: Dict[PageType, int] = {t: 0 for t in PageType}
        for pid, st in self._pages.items():
            hit = pid in self._current_touched
            st.bitmap = ((st.bitmap << 1) | int(hit)) & ((1 << HISTORY_BITS) - 1)
            if hit:
                touched_by_type[st.page_type] += 1
        res = dict(resident) if resident else {
            t: sum(1 for s in self._pages.values() if s.page_type == t)
            for t in PageType
        }
        summary = IntervalSummary(
            interval=self._interval,
            touched=touched_by_type,
            resident=res,
            samples=self._interval_samples,
        )
        self._summaries.append(summary)
        self._current_touched = set()
        self._interval_samples = 0
        self._interval += 1
        return summary

    # ---------------------------------------------------------------- #
    # Insights (the paper's figures)
    # ---------------------------------------------------------------- #
    def temperature_fractions(
        self, window: int = 2
    ) -> Dict[PageType, Dict[str, float]]:
        """Hot/warm/cold fractions over the last ``window`` intervals
        (Fig. 7/8 with N-minute windows).

        hot  — touched in every one of the last ``window`` intervals;
        warm — touched in ≥1 but not all;
        cold — touched in none.
        """
        out: Dict[PageType, Dict[str, float]] = {}
        mask = (1 << window) - 1
        for ptype in PageType:
            pages = [s for s in self._pages.values() if s.page_type == ptype]
            n = len(pages)
            if n == 0:
                out[ptype] = {"hot": 0.0, "warm": 0.0, "cold": 0.0}
                continue
            hot = sum(1 for s in pages if (s.bitmap & mask) == mask)
            cold = sum(1 for s in pages if (s.bitmap & mask) == 0)
            out[ptype] = {
                "hot": hot / n,
                "warm": (n - hot - cold) / n,
                "cold": cold / n,
            }
        return out

    def idle_fraction(self, window: int = 2) -> float:
        """Fraction of tracked memory idle over the window (paper: 55-80%)."""
        pages = list(self._pages.values())
        if not pages:
            return 0.0
        mask = (1 << window) - 1
        idle = sum(1 for s in pages if (s.bitmap & mask) == 0)
        return idle / len(pages)

    def reaccess_cdf(self, max_gap: int = 32) -> np.ndarray:
        """P(re-access gap ≤ g) for g in [1, max_gap] (Fig. 11)."""
        gaps = np.asarray(self._reaccess_gaps, dtype=np.int64)
        cdf = np.zeros(max_gap, dtype=np.float64)
        if gaps.size == 0:
            return cdf
        for g in range(1, max_gap + 1):
            cdf[g - 1] = float((gaps <= g).mean())
        return cdf

    def heatmap(self, intervals: int = 32, bins: int = 64) -> np.ndarray:
        """(bins × intervals) page-activity heat map, pages binned by id."""
        if not self._pages:
            return np.zeros((bins, intervals))
        pids = sorted(self._pages)
        hm = np.zeros((bins, intervals), dtype=np.float64)
        cnt = np.zeros((bins, 1), dtype=np.float64)
        for rank, pid in enumerate(pids):
            b = min(bins - 1, rank * bins // len(pids))
            bm = self._pages[pid].bitmap
            cnt[b, 0] += 1
            for i in range(intervals):
                hm[b, i] += (bm >> i) & 1
        return hm / np.maximum(cnt, 1.0)

    def usage_over_time(self) -> List[IntervalSummary]:
        """Per-interval touched/resident counts per type (Fig. 9)."""
        return list(self._summaries)

    @property
    def total_samples(self) -> int:
        return sum(s.samples for s in self._pages.values())
