"""The one traffic generator: a workload file's parameters and a seed in,
requests out.

Lengths are log-uniform, drawn stratified: a block of ``block`` requests
takes the block's quantiles ``(i + 0.5) / block`` of the range, in an
order that the workload's fixed ``shape_seed`` draws.  So every run
offers the same sizes in the same order, and the run's seed draws the
prompt tokens (and the weights): a window's work does not move with the
seed.

* ``"loop": "closed"`` — ``lanes`` clients, each replaced when its
  request finishes.  With ``snapshot`` the first ``lanes`` requests
  carry a stratified share of their output already in their prompt, so
  the window opens on a batch in mid-flight.
* ``"loop": "open"`` — arrivals from the copied ``BurstyArrivals`` (or
  ``PoissonArrivals``) at the workload's mean rate in requests a second.
  One trace, drawn from the workload's fixed ``shape_seed`` and scaled
  to the window, with the sizes in an order that seed draws, serves
  every seed: the run's seed draws the tokens (and the weights), so
  every seed offers the same work on the same schedule.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np

from portbench.harness.arrivals import BurstyArrivals, PoissonArrivals


@dataclasses.dataclass(frozen=True)
class Req:
    index: int
    prompt: List[int]
    max_new: int
    due: Optional[float] = None  # seconds after the window opens (open loop)


def loguniform_grid(lo: int, hi: int, n: int) -> np.ndarray:
    """The ``n`` quantiles ``(i + 0.5) / n`` of a log-uniform ``[lo, hi]``."""
    u = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))).astype(np.int64)


def _tokens(seed: int, index: int, n: int, vocab: int, stream: int = 0) -> List[int]:
    return np.random.default_rng([seed, 3, stream, index]).integers(0, vocab, n).tolist()


class ClosedTraffic:
    """The closed loop's requests: ``snapshot`` (the first ``lanes``, set-up
    admits them) and :meth:`refill` ``(i)``, the ``i``-th replacement,
    without end.  Refill block ``b`` is a shuffle of the block grid drawn
    from the shape seed and ``b``."""

    def __init__(self, w: Dict[str, Any], seed: int, vocab: int) -> None:
        self.w, self.seed, self.vocab = w, seed, vocab
        lanes = w["lanes"]
        rng = np.random.default_rng([int(w["shape_seed"]), 1])
        plo, phi = w["prompt_len"]
        olo, ohi = w["output_len"]
        snap_p = rng.permutation(loguniform_grid(plo, phi, lanes))
        snap_o = rng.permutation(loguniform_grid(olo, ohi, lanes))
        snap_u = rng.permutation((np.arange(lanes) + 0.5) / lanes)
        self.snapshot = []
        for i in range(lanes):
            plen, out = int(snap_p[i]), int(snap_o[i])
            done = int(snap_u[i] * out) if w.get("snapshot") else 0
            # the part already served stands in the prompt as drawn tokens
            self.snapshot.append(Req(index=i, prompt=_tokens(seed, i, plen + done, vocab),
                                     max_new=out - done))
        self._block: Dict[int, Any] = {}

    def refill(self, i: int) -> Req:
        block = self.w.get("block", 16)
        b, k = divmod(i, block)
        if b not in self._block:
            rng = np.random.default_rng([int(self.w["shape_seed"]), 5, b])
            self._block = {b: (rng.permutation(loguniform_grid(*self.w["prompt_len"], block)),
                               rng.permutation(loguniform_grid(*self.w["output_len"], block)))}
        plens, outs = self._block[b]
        index = self.w["lanes"] + i
        return Req(index=index, prompt=_tokens(self.seed, index, int(plens[k]), self.vocab),
                   max_new=int(outs[k]))


def arrival_offsets(a: Dict[str, Any], horizon: float) -> np.ndarray:
    """Due times in ``[0, horizon)``: the first ``round(rate * horizon)``
    arrivals of the workload's one trace, its unitless times scaled so
    that the next arrival would fall at ``horizon`` (the offered rate is
    the stated one)."""
    rate = float(a["mean_rate"])
    if a["kind"] == "bursty":
        on, off = float(a["mean_on_s"]), float(a["mean_off_s"])
        idle = float(a.get("idle_rate", 0.0))
        burst = (rate * (on + off) - idle * off) / on  # the mean rate is ``rate``
        proc = BurstyArrivals(burst_rate=burst, idle_rate=idle, mean_burst=on,
                              mean_idle=off)
    elif a["kind"] == "poisson":
        proc = PoissonArrivals(rate=rate)
    else:
        raise ValueError(f"unknown arrival kind {a['kind']!r}")
    n = int(round(rate * horizon))
    times = []
    for t in proc.times(np.random.default_rng(int(a["shape_seed"]))):
        times.append(t)
        if len(times) > n:
            break
    return np.asarray(times[:n]) * (horizon / times[n])


def open_requests(w: Dict[str, Any], seed: int, vocab: int, horizon: float) -> List[Req]:
    """The open loop's requests over a window of ``horizon`` seconds."""
    due = arrival_offsets(w["arrivals"], horizon)
    n = len(due)
    rng = np.random.default_rng([int(w["arrivals"]["shape_seed"]), 1])
    plens = rng.permutation(loguniform_grid(*w["prompt_len"], max(n, 1)))
    outs = rng.permutation(loguniform_grid(*w["output_len"], max(n, 1)))
    return [Req(index=i, prompt=_tokens(seed, i, int(plens[i]), vocab),
                max_new=int(outs[i]), due=float(due[i])) for i in range(n)]


def warmup_requests(w: Dict[str, Any], seed: int, vocab: int) -> List[Req]:
    """Set-up's requests for an open loop: the shortest, the median and the
    longest prompt of the mix, a few tokens each."""
    plo, phi = w["prompt_len"]
    mid = int(round(math.sqrt(plo * phi)))
    return [Req(index=-1 - i, prompt=_tokens(seed, i, p, vocab, stream=1), max_new=4)
            for i, p in enumerate((plo, mid, phi))]


def max_pages(w: Dict[str, Any], page_size: int) -> int:
    """Pages one lane reaches at its longest: ``prompt + output - 1``
    written tokens (the snapshot's carried part counts in the output)."""
    return -(-(w["prompt_len"][1] + w["output_len"][1] - 1) // page_size)
