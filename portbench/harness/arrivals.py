"""Arrival processes, copied from ``repro_torch/traffic/arrivals.py``
(``PoissonArrivals``; ``BurstyArrivals``, a 2-state MMPP).  Seeded and
pure data: the times are unitless, and the traffic generator scales
them to wall-clock seconds.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


class ArrivalProcess:
    """Base arrival process: yields absolute arrival times."""

    kind = "base"

    def times(self, rng: np.random.Generator) -> Iterator[float]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Memoryless arrivals at ``rate`` requests/second."""

    rate: float
    kind = "poisson"

    def __post_init__(self) -> None:
        if self.rate <= 0:
            raise ValueError(f"rate must be positive (got {self.rate})")

    def times(self, rng: np.random.Generator) -> Iterator[float]:
        t = 0.0
        while True:
            t += rng.exponential(1.0 / self.rate)
            yield t


@dataclasses.dataclass(frozen=True)
class BurstyArrivals(ArrivalProcess):
    """2-state MMPP: Poisson bursts separated by (near-)idle gaps.

    ``burst_rate``/``idle_rate`` are the per-state Poisson rates;
    ``mean_burst``/``mean_idle`` the exponential mean dwell times.  The
    long-run average rate is the dwell-weighted mix of the two state
    rates — size it against :class:`PoissonArrivals` for a fair
    comparison at equal offered load.
    """

    burst_rate: float
    idle_rate: float = 0.0
    mean_burst: float = 2.0
    mean_idle: float = 6.0
    kind = "bursty"

    def __post_init__(self) -> None:
        if self.burst_rate <= 0:
            raise ValueError(
                f"burst_rate must be positive (got {self.burst_rate})"
            )
        if self.idle_rate < 0:
            raise ValueError(
                f"idle_rate must be >= 0 (got {self.idle_rate})"
            )
        if self.mean_burst <= 0 or self.mean_idle <= 0:
            raise ValueError("mean dwell times must be positive")

    @property
    def mean_rate(self) -> float:
        """Long-run offered rate (dwell-weighted state mix)."""
        total = self.mean_burst + self.mean_idle
        return (self.burst_rate * self.mean_burst
                + self.idle_rate * self.mean_idle) / total

    def times(self, rng: np.random.Generator) -> Iterator[float]:
        t = 0.0
        on = True  # start in the burst state (deterministic)
        state_end = rng.exponential(self.mean_burst)
        while True:
            rate = self.burst_rate if on else self.idle_rate
            if rate <= 0.0:
                t = state_end
                on = not on
                state_end = t + rng.exponential(
                    self.mean_burst if on else self.mean_idle)
                continue
            gap = rng.exponential(1.0 / rate)
            if t + gap <= state_end:
                t += gap
                yield t
            else:
                # no arrival before the state flips; move to the flip
                # (memorylessness makes discarding the partial draw exact)
                t = state_end
                on = not on
                state_end = t + rng.exponential(
                    self.mean_burst if on else self.mean_idle)
