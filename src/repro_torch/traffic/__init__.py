"""Continuous-batching serving front end over the tiered data plane.

The subsystem splits into four layers, composed by the scheduler:

* :mod:`repro_torch.traffic.arrivals` — seed-deterministic request traces
  (Poisson and bursty/MMPP arrival processes, per-tenant QoS mixes);
* :mod:`repro_torch.traffic.slots` — the JetStream-style
  prefill/insert/generate slot engine over
  :class:`~repro_torch.serving.engine.ServingEngine`;
* :mod:`repro_torch.traffic.latency` — the modeled latency clock (queueing +
  prefill + residency-dependent decode) and per-class SLO metrics;
* :mod:`repro_torch.traffic.scheduler` — the admission queue, lane refill,
  and control-plane pause/evict relief driving it all.

Counterpart of ``repro/traffic/``: copies with the same behaviour
(NumPy and the standard library), over the port's ``ServingEngine``,
``core.control`` and ``qos.quota``.  The traces, the modeled clock and
every count equal the JAX package's on the same engine configuration
(``tests/test_torch_traffic_reference.py``).
"""

from repro_torch.traffic.arrivals import (
    ArrivalProcess,
    BurstyArrivals,
    ClassMix,
    DEFAULT_MIX,
    PoissonArrivals,
    RequestSpec,
    generate_trace,
)
from repro_torch.traffic.latency import (
    ClassMetrics,
    DEFAULT_TRAFFIC_SLO,
    LatencyModel,
    RequestRecord,
    make_class_metrics,
)
from repro_torch.traffic.scheduler import (
    TrafficConfig,
    TrafficResult,
    TrafficScheduler,
)
from repro_torch.traffic.slots import SlotEngine, SlotError, SlotInfo

__all__ = [
    "ArrivalProcess",
    "BurstyArrivals",
    "ClassMetrics",
    "ClassMix",
    "DEFAULT_MIX",
    "DEFAULT_TRAFFIC_SLO",
    "LatencyModel",
    "PoissonArrivals",
    "RequestRecord",
    "RequestSpec",
    "SlotEngine",
    "SlotError",
    "SlotInfo",
    "TrafficConfig",
    "TrafficResult",
    "TrafficScheduler",
    "generate_trace",
    "make_class_metrics",
]
