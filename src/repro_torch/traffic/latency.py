"""Latency accounting: a simulated clock modeled from tier residency.

The front end never measures wall time — tokens/sec of a smoke-sized
model on CI hardware says nothing about tiering.  A copy of
``repro/traffic/latency.py`` with the same constants, so that the port's
summaries equal the JAX package's; a card's own wall times are measured
apart from this clock (``chip_smoke.py``'s ``[traffic]`` lines).  Instead every request
accrues *modeled* time through three phases, and the tier split of its
own page accesses sets its decode speed:

* **queueing** — arrival until its prefill starts (the admission queue
  plus lanes being busy);
* **prefill** — ``prefill_token_ms × prompt_len``: prompt KV lands in
  the cache (prefill is compute-bound, tier-independent — writes land
  wherever allocation steered them).  Prefill is modeled
  *disaggregated* (JetStream-style separate prefill workers): it
  delays the request's own token timeline (``RequestRecord.offset_ms``)
  but never stalls the shared decode clock;
* **decode** — per generated token, ``decode_base_ms`` plus
  ``slow_hit_ms`` per slow-tier page hit of *that lane's* step (reads
  of slow/CXL-resident pages are the paper's access asymmetry).  A lane
  whose working set TPP keeps fast decodes at near-base speed; one
  reading demoted pages pays per hit.

One engine step serves all lanes (continuous batching), so the global
clock advances by the *slowest* lane's step time while each lane's
token timestamps use its own — per-request TTFT/TPOT then reflect that
request's residency, which is exactly the signal the SLO benchmark
needs.

:class:`ClassMetrics` aggregates completions per QoS class: TTFT
(arrival → first token), TPOT (mean inter-token gap), and *goodput* —
SLO-meeting completions per simulated second, the serving-side goodness
measure the benchmark compares shed-only admission against control-plane
victim relief on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

#: Default per-class SLOs in simulated milliseconds.  TTFT bounds the
#: queue+prefill path, TPOT the steady decode rate; the spread mirrors
#: the slowdown targets of :data:`repro_torch.qos.controller.DEFAULT_SLO`
#: (latency-critical tight, batch loose).
DEFAULT_TRAFFIC_SLO: Dict[str, Tuple[float, float]] = {
    "latency_critical": (60.0, 3.0),
    "standard": (120.0, 5.0),
    "batch": (400.0, 10.0),
}


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Cost constants of the modeled serving clock (milliseconds)."""

    prefill_token_ms: float = 0.5
    decode_base_ms: float = 1.0
    slow_hit_ms: float = 0.5

    def prefill_ms(self, prompt_len: int) -> float:
        return self.prefill_token_ms * prompt_len

    def decode_ms(self, fast_hits: int, slow_hits: int) -> float:
        """One lane's step time from its own tier hit split."""
        return self.decode_base_ms + self.slow_hit_ms * slow_hits


@dataclasses.dataclass
class RequestRecord:
    """Per-request latency ledger (keyed by the trace index)."""

    index: int
    qos_class: str
    tenant: int
    arrival: float
    attempts: int = 0  # admissions (>1 after an eviction restart)
    # this attempt's prefill delay: added to every token timestamp
    # (disaggregated prefill shifts the request's whole decode timeline)
    offset_ms: float = 0.0
    first_token: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    finished: Optional[float] = None
    dropped: bool = False

    def restart(self) -> None:
        """An eviction threw the attempt away — tokens regenerate."""
        self.first_token = None
        self.token_times = []

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        if self.finished is None or len(self.token_times) < 2:
            return None
        return ((self.token_times[-1] - self.token_times[0])
                / (len(self.token_times) - 1))


def _percentile(xs: List[float], p: float) -> Optional[float]:
    if not xs:
        return None
    return float(np.percentile(np.asarray(xs, np.float64), p))


@dataclasses.dataclass
class ClassMetrics:
    """Completion metrics of one QoS class over a traffic run."""

    qos_class: str
    slo_ttft_ms: float
    slo_tpot_ms: float
    arrived: int = 0
    completed: int = 0
    slo_met: int = 0
    dropped: int = 0  # admission-queue overflow
    shed: int = 0  # control-plane batch sheds
    evicted: int = 0  # preempted lanes (restarted)
    paused: int = 0  # paused lanes (resumed later)
    ttft: List[float] = dataclasses.field(default_factory=list)
    tpot: List[float] = dataclasses.field(default_factory=list)

    def complete(self, rec: RequestRecord) -> None:
        self.completed += 1
        ttft, tpot = rec.ttft, rec.tpot
        ok = True
        if ttft is not None:
            self.ttft.append(ttft)
            ok &= ttft <= self.slo_ttft_ms
        if tpot is not None:
            self.tpot.append(tpot)
            ok &= tpot <= self.slo_tpot_ms
        if ok:
            self.slo_met += 1

    def goodput(self, horizon_s: float) -> float:
        """SLO-meeting completions per simulated second."""
        if horizon_s <= 0:
            return 0.0
        return self.slo_met / horizon_s

    def summary(self, horizon_ms: float) -> Dict[str, object]:
        horizon_s = horizon_ms / 1e3
        return {
            "arrived": self.arrived,
            "completed": self.completed,
            "slo_met": self.slo_met,
            "dropped": self.dropped,
            "shed": self.shed,
            "evicted": self.evicted,
            "paused": self.paused,
            "goodput_rps": round(self.goodput(horizon_s), 4),
            "ttft_p50_ms": _round(_percentile(self.ttft, 50)),
            "ttft_p99_ms": _round(_percentile(self.ttft, 99)),
            "tpot_p50_ms": _round(_percentile(self.tpot, 50)),
            "tpot_p99_ms": _round(_percentile(self.tpot, 99)),
        }


def _round(x: Optional[float]) -> Optional[float]:
    return None if x is None else round(x, 3)


def make_class_metrics(
    slo: Optional[Mapping[str, Tuple[float, float]]] = None,
) -> Dict[str, ClassMetrics]:
    """One :class:`ClassMetrics` per configured QoS class."""
    table = dict(DEFAULT_TRAFFIC_SLO)
    if slo:
        table.update(slo)
    return {
        cls: ClassMetrics(cls, slo_ttft_ms=t[0], slo_tpot_ms=t[1])
        for cls, t in sorted(table.items())
    }
