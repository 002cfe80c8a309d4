"""Arrival processes: request traces for the serving front end.

A *trace* is pure data — a time-ordered tuple of :class:`RequestSpec`
(arrival time, tenant, QoS class, prompt tokens, decode length) fully
determined by the generator seed.  Engine-agnosticism is by
construction: the trace never touches an engine, so the same object
drives the reference and batched data planes identically
(``tests/test_torch_traffic.py`` pins both properties).  A copy of
``repro/traffic/arrivals.py``: one seed gives the JAX package's trace,
field for field.

Two processes, the canonical serving-traffic shapes:

* :class:`PoissonArrivals` — memoryless arrivals at a fixed rate, the
  steady-traffic baseline every queueing result is quoted against.
* :class:`BurstyArrivals` — a 2-state MMPP (Markov-modulated Poisson
  process): exponential dwell times alternate an *on* state (burst
  rate) with an *off* state (idle rate, possibly 0).  Bursts are what
  actually stress TPP's allocation-headroom story — a burst's prefills
  are exactly the short-lived hot allocations §3 of the paper measures,
  and they arrive precisely when the fast tier has had no quiet period
  to reclaim in.

Times are unitless "seconds" of the simulated latency clock
(:mod:`repro_torch.traffic.latency`); rates are requests per second.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One request of a traffic trace (immutable, engine-agnostic)."""

    index: int  # position in the trace (the metrics key)
    t: float  # arrival time (simulated seconds)
    tenant: int
    qos_class: str
    prompt: Tuple[int, ...]
    max_new: int


@dataclasses.dataclass(frozen=True)
class ClassMix:
    """One tenant's slice of the workload mix.

    ``weight`` is the arrival fraction routed to this tenant;
    ``prompt_len``/``max_new`` are inclusive uniform ranges drawn per
    request (long prompts = heavy prefill allocation bursts).
    """

    qos_class: str
    tenant: int
    weight: float
    prompt_len: Tuple[int, int] = (12, 20)
    max_new: Tuple[int, int] = (8, 16)


#: A small three-class default mix: a latency-critical interactive
#: tenant, a standard tenant, and a long-prompt batch tenant.
DEFAULT_MIX: Tuple[ClassMix, ...] = (
    ClassMix("latency_critical", 0, 0.35, prompt_len=(10, 16),
             max_new=(8, 12)),
    ClassMix("standard", 1, 0.35, prompt_len=(12, 20), max_new=(8, 16)),
    ClassMix("batch", 2, 0.30, prompt_len=(24, 40), max_new=(12, 20)),
)


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


def generate_trace(
    process: ArrivalProcess,
    *,
    seed: int,
    vocab: int,
    horizon: Optional[float] = None,
    max_requests: Optional[int] = None,
    mix: Sequence[ClassMix] = DEFAULT_MIX,
) -> Tuple[RequestSpec, ...]:
    """Materialize a request trace from an arrival process.

    One ``np.random.default_rng(seed)`` stream drives arrival times,
    class choice, prompt lengths, decode lengths, and prompt tokens in a
    fixed order — so the trace is a pure function of ``(process
    parameters, seed, vocab, horizon/max_requests, mix)``.  At least one
    of ``horizon``/``max_requests`` must bound it.
    """
    if horizon is None and max_requests is None:
        raise ValueError("bound the trace with horizon or max_requests")
    if not mix:
        raise ValueError("the workload mix is empty")
    weights = np.asarray([m.weight for m in mix], np.float64)
    if (weights <= 0).any():
        raise ValueError("every ClassMix weight must be positive")
    weights = weights / weights.sum()
    rng = np.random.default_rng(seed)
    out: List[RequestSpec] = []
    for t in process.times(rng):
        if horizon is not None and t > horizon:
            break
        if max_requests is not None and len(out) >= max_requests:
            break
        m = mix[int(rng.choice(len(mix), p=weights))]
        plen = int(rng.integers(m.prompt_len[0], m.prompt_len[1] + 1))
        max_new = int(rng.integers(m.max_new[0], m.max_new[1] + 1))
        prompt = tuple(int(x) for x in rng.integers(0, vocab, plen))
        out.append(RequestSpec(
            index=len(out), t=float(t), tenant=m.tenant,
            qos_class=m.qos_class, prompt=prompt, max_new=max_new,
        ))
    return tuple(out)
