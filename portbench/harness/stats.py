"""The arithmetic of the end-to-end metrics, on host-clock token times.

Every statistic is taken over all the samples of the window: a rate over
all its tokens and all its seconds, a tail over every gap or every
request due in it.  None is a median of chunks.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile by linear interpolation between order
    statistics (numpy's default); raises on no samples."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def tokens_per_s(token_times: Dict[int, List[float]], t0: float, t1: float) -> float:
    """Every token returned in ``[t0, t1]`` over the window's seconds."""
    n = sum(1 for ts in token_times.values() for t in ts if t0 <= t <= t1)
    return n / (t1 - t0)


def token_gaps(token_times: Dict[int, List[float]], t0: float, t1: float) -> List[float]:
    """Seconds between consecutive tokens of a request, both in the window."""
    gaps = []
    for ts in token_times.values():
        inside = [t for t in ts if t0 <= t <= t1]
        gaps.extend(b - a for a, b in zip(inside, inside[1:]))
    return gaps


def ttfts(due: Dict[int, float], first_token: Dict[int, float], t0: float,
          t1: float) -> List[float]:
    """Time to first token of every request due in the window, from its
    due time; a request with no token by ``t1`` counts its wait so far."""
    out = []
    for rid, d in due.items():
        if t0 <= d <= t1:
            first = first_token.get(rid)
            out.append((first if first is not None and first <= t1 else t1) - d)
    return out
