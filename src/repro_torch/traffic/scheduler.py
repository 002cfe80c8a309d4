"""The request scheduler: traffic-driven continuous batching under SLOs.

:class:`TrafficScheduler` (a copy of ``repro/traffic/scheduler.py``)
closes the serving loop: an arrival trace
(:mod:`repro_torch.traffic.arrivals`) feeds a bounded admission queue;
free decode lanes refill through the slot engine's prefill/insert verbs;
every generate step advances the modeled latency clock
(:mod:`repro_torch.traffic.latency`); and fast-tier pressure escalates
through the tiering control plane —

1. **shed** — the engine's existing batch-class admission gate
   (``AdmissionError reason="qos_pressure"``) refuses *new* batch work;
2. **evict/pause** — when :meth:`TieringControl.relief_action` reports
   that shedding alone has not relieved the fast tier, the scheduler
   builds one :class:`~repro_torch.core.control.VictimCandidate` per occupied
   lane and asks :meth:`TieringControl.order_pressure_victims` for the
   Equilibria-style ordering (lowest share × coldest residency).  A
   batch-class victim is **evicted** — its lane releases, every frame
   frees instantly, and the request re-queues for a fresh attempt; any
   other class is **paused** — its pages retype FILE and demote through
   TPP's normal reclaim, and the lane resumes ``pause_steps`` later.

Queue overflow raises (and internally accounts)
:class:`~repro_torch.serving.engine.AdmissionError` with
``reason="queue_full"`` — arrivals beyond the queue bound are dropped
load, the shed-only baseline's only relief valve.

The result (:class:`TrafficResult`) reports per-class goodput and
TTFT/TPOT percentiles — ``serving_bench``'s fixed-batch tokens/sec
replaced by real traffic metrics.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Mapping, Optional, Tuple, Union

from repro_torch.core.control import VictimCandidate
from repro_torch.qos.quota import DEFAULT_PRIORITY
from repro_torch.serving.engine import AdmissionError, ServingEngine
from repro_torch.traffic.arrivals import RequestSpec
from repro_torch.traffic.latency import (
    ClassMetrics,
    LatencyModel,
    RequestRecord,
    make_class_metrics,
)
from repro_torch.traffic.slots import SlotEngine


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Front-end tunables.

    * ``queue_cap`` — admission-queue bound; arrivals past it drop with
      ``AdmissionError(reason="queue_full")``.
    * ``relief`` — ``"shed"`` keeps only the engine's batch admission
      gate (the shed-only baseline); ``"control"`` additionally
      consults ``relief_action``/``order_pressure_victims`` for
      pause/evict victims; ``"none"`` disables both scheduler-side
      levers (pure queueing).
    * ``pause_steps`` — generate steps a paused victim sits out.
    * ``max_victims`` — victims acted on per pressured step.
    * ``evict_backoff_steps`` — after an eviction, batch-class refills
      are held back this many steps.  Without the hold, the evicted
      request re-admits the moment the freed frames clear the
      watermarks, re-creating the pressure the eviction just relieved
      (evict/readmit thrash); with it, the relief persists long enough
      for the latency-critical lanes to regain fast residency.
    * ``latency`` / ``slo`` — the modeled clock and per-class
      (TTFT, TPOT) targets (defaults
      :data:`~repro_torch.traffic.latency.DEFAULT_TRAFFIC_SLO`).
    * ``eos_id`` — optional early-EOS token id.
    * ``stall_limit`` — consecutive no-progress steps before the queue
      head is force-dropped (termination backstop when every queued
      request is being shed).
    """

    queue_cap: int = 32
    relief: str = "control"
    pause_steps: int = 8
    max_victims: int = 1
    evict_backoff_steps: int = 16
    latency: LatencyModel = dataclasses.field(default_factory=LatencyModel)
    slo: Optional[Mapping[str, Tuple[float, float]]] = None
    eos_id: Optional[int] = None
    stall_limit: int = 256

    def __post_init__(self) -> None:
        if self.relief not in ("none", "shed", "control"):
            raise ValueError(
                f"unknown relief mode {self.relief!r}; "
                "choose none|shed|control"
            )
        if self.queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1 (got {self.queue_cap})")
        if self.pause_steps < 1 or self.max_victims < 1:
            raise ValueError("pause_steps and max_victims must be >= 1")
        if self.evict_backoff_steps < 0:
            raise ValueError("evict_backoff_steps must be >= 0")


@dataclasses.dataclass
class TrafficResult:
    """Outcome of a traffic run (see :meth:`summary`)."""

    horizon_ms: float
    steps: int
    per_class: Dict[str, ClassMetrics]
    evictions: int
    pauses: int
    drops: int
    sheds: int
    engine_stats: Dict[str, object]

    def goodput(self, qos_class: str) -> float:
        m = self.per_class.get(qos_class)
        if m is None:
            return 0.0
        return m.goodput(self.horizon_ms / 1e3)

    @property
    def lc_goodput(self) -> float:
        return self.goodput("latency_critical")

    def summary(self) -> Dict[str, object]:
        return {
            "horizon_ms": round(self.horizon_ms, 3),
            "steps": self.steps,
            "evictions": self.evictions,
            "pauses": self.pauses,
            "drops": self.drops,
            "sheds": self.sheds,
            "per_class": {
                cls: m.summary(self.horizon_ms)
                for cls, m in self.per_class.items()
                if m.arrived or m.completed
            },
        }


class TrafficScheduler:
    """Drive a slot engine from an arrival trace under a modeled clock."""

    def __init__(
        self,
        engine: Union[ServingEngine, SlotEngine],
        trace: Tuple[RequestSpec, ...],
        config: Optional[TrafficConfig] = None,
    ) -> None:
        self.cfg = config or TrafficConfig()
        self.slots = (engine if isinstance(engine, SlotEngine)
                      else SlotEngine(engine, eos_id=self.cfg.eos_id))
        self.engine = self.slots.engine
        self.trace = tuple(trace)
        if any(self.trace[i].t > self.trace[i + 1].t
               for i in range(len(self.trace) - 1)):
            raise ValueError("trace must be time-ordered")
        self.clock_ms = 0.0
        self.queue: Deque[RequestSpec] = deque()
        self.records: Dict[int, RequestRecord] = {}
        # trace index -> generated tokens (the parity surface: the same
        # trace must produce the same tokens on either data plane)
        self.completed: Dict[int, List[int]] = {}
        self.metrics = make_class_metrics(self.cfg.slo)
        self._next = 0  # next trace index to ingest
        self._rid_index: Dict[int, int] = {}  # rid -> trace index
        self._paused: Dict[int, int] = {}  # slot -> steps left
        self._batch_hold = 0  # steps batch refills stay held post-evict
        self._stall = 0
        self.steps = 0
        self.evictions = 0
        self.pauses = 0
        self.drops = 0
        self.sheds = 0

    # ---------------------------------------------------------------- #
    # admission queue
    # ---------------------------------------------------------------- #
    def offer(self, spec: RequestSpec) -> None:
        """Enqueue an arrival; overflow raises ``queue_full``."""
        if len(self.queue) >= self.cfg.queue_cap:
            raise AdmissionError(
                f"admission queue at queue_cap={self.cfg.queue_cap}",
                reason="queue_full",
            )
        self.queue.append(spec)

    def _metric(self, qos_class: str) -> ClassMetrics:
        if qos_class not in self.metrics:
            self.metrics[qos_class] = ClassMetrics(
                qos_class, slo_ttft_ms=float("inf"),
                slo_tpot_ms=float("inf"))
        return self.metrics[qos_class]

    def _ingest(self) -> None:
        while self._next < len(self.trace):
            spec = self.trace[self._next]
            if spec.t * 1e3 > self.clock_ms:
                break
            self._next += 1
            rec = RequestRecord(
                index=spec.index, qos_class=spec.qos_class,
                tenant=spec.tenant, arrival=spec.t * 1e3,
            )
            self.records[spec.index] = rec
            self._metric(spec.qos_class).arrived += 1
            try:
                self.offer(spec)
            except AdmissionError:
                rec.dropped = True
                self.drops += 1
                self._metric(spec.qos_class).dropped += 1

    # ---------------------------------------------------------------- #
    # control-plane relief: pause/evict victims
    # ---------------------------------------------------------------- #
    def _relieve(self) -> None:
        control = self.engine.control
        if self.cfg.relief != "control" or control is None:
            return
        if control.relief_action(self.engine.kv.pool) != "evict":
            return
        candidates = [
            VictimCandidate(
                key=info.slot, tenant=info.tenant,
                pids=self.slots.pages_of(info.slot),
                qos_class=info.qos_class,
            )
            for info in self.slots.occupied() if not info.paused
        ]
        victims = control.order_pressure_victims(
            candidates, self.engine.kv.pool)
        for v in victims[: self.cfg.max_victims]:
            info = self.slots.lanes[v.key]
            rec = self.records.get(self._rid_index.get(info.rid, -1))
            if v.qos_class == "batch":
                # evict: the lane's frames free at once, the request
                # restarts from the queue front
                del self._rid_index[info.rid]
                req = self.slots.evict(v.key)
                spec = self.trace[rec.index] if rec is not None else None
                self.evictions += 1
                self._batch_hold = max(self._batch_hold,
                                       self.cfg.evict_backoff_steps)
                self._metric(v.qos_class).evicted += 1
                if rec is not None and spec is not None:
                    rec.restart()
                    if len(self.queue) < self.cfg.queue_cap:
                        self.queue.appendleft(spec)
                    else:
                        rec.dropped = True
                        self.drops += 1
                        self._metric(v.qos_class).dropped += 1
                del req
            else:
                # pause: pages retype FILE and demote through reclaim
                self.slots.pause(v.key)
                self._paused[v.key] = self.cfg.pause_steps
                self.pauses += 1
                self._metric(v.qos_class).paused += 1

    def _tick_paused(self) -> None:
        for slot in list(self._paused):
            self._paused[slot] -= 1
            if self._paused[slot] <= 0:
                del self._paused[slot]
                self.slots.resume(slot)

    # ---------------------------------------------------------------- #
    # lane refill (prefill + insert)
    # ---------------------------------------------------------------- #
    def _refill(self) -> int:
        admitted = 0
        free = self.slots.free_slots()
        while free and self.queue:
            picked = None
            # class-aware refill: highest priority class first, FIFO
            # within a class — an evicted batch restart never jumps a
            # waiting latency-critical request
            order = sorted(
                enumerate(self.queue),
                key=lambda iq: (-DEFAULT_PRIORITY.get(iq[1].qos_class, 2.0),
                                iq[0]),
            )
            for qi, spec in order:
                if spec.qos_class == "batch" and self._batch_hold > 0:
                    continue  # post-eviction hold: relief must persist
                try:
                    rid = self.slots.prefill(
                        list(spec.prompt), max_new=spec.max_new,
                        qos_class=spec.qos_class, tenant=spec.tenant,
                    )
                except AdmissionError as e:
                    if e.reason == "qos_pressure":
                        # engine shed this batch request; later queue
                        # entries of other classes may still admit
                        self.sheds += 1
                        self._metric(spec.qos_class).shed += 1
                        continue
                    raise  # max_seqs here is a lane-accounting bug
                picked = (qi, spec, rid)
                break
            if picked is None:
                break  # everything admissible was shed this step
            qi, spec, rid = picked
            del self.queue[qi]
            slot = free.pop(0)
            self.slots.insert(rid, slot)
            self._rid_index[rid] = spec.index
            rec = self.records[spec.index]
            rec.attempts += 1
            # disaggregated prefill: the prompt charge delays this
            # request's own token timeline, not the shared decode clock
            rec.offset_ms = self.cfg.latency.prefill_ms(len(spec.prompt))
            admitted += 1
        return admitted

    # ---------------------------------------------------------------- #
    # one scheduler step
    # ---------------------------------------------------------------- #
    def step_once(self) -> bool:
        """Ingest, relieve, refill, generate; returns True while work
        remains (pending arrivals, queued requests, or occupied lanes)."""
        lat = self.cfg.latency
        self._ingest()
        self._relieve()
        self._tick_paused()
        if self._batch_hold > 0:
            self._batch_hold -= 1
        admitted = self._refill()
        occupied = self.slots.occupied()
        if occupied:
            out = self.slots.generate()
            self.steps += 1
            step_ms = lat.decode_base_ms
            for slot, (tok, done) in out.items():
                fast, slow = self.slots.last_hits(slot)
                lane_ms = lat.decode_ms(fast, slow)
                step_ms = max(step_ms, lane_ms)
                idx = self._rid_index.get(self.slots.lanes[slot].rid)
                rec = self.records.get(idx) if idx is not None else None
                if rec is not None:
                    t_tok = self.clock_ms + lane_ms + rec.offset_ms
                    if rec.first_token is None:
                        rec.first_token = t_tok
                    rec.token_times.append(t_tok)
                    if done:
                        rec.finished = t_tok
                if done:
                    rid = self.slots.lanes[slot].rid
                    self._rid_index.pop(rid, None)
                    self._paused.pop(slot, None)
                    req = self.slots.release(slot)
                    if rec is not None:
                        self.completed[rec.index] = list(req.out)
                        self._metric(rec.qos_class).complete(rec)
            self.clock_ms += step_ms
            self._stall = 0
        elif self.queue:
            # nothing running and nothing admitted (all shed): let
            # modeled time pass so pool pressure can clear; force-drop
            # the head if it never does
            self.clock_ms += lat.decode_base_ms
            if admitted == 0:
                self._stall += 1
                if self._stall >= self.cfg.stall_limit:
                    spec = self.queue.popleft()
                    rec = self.records[spec.index]
                    rec.dropped = True
                    self.drops += 1
                    self._metric(spec.qos_class).dropped += 1
                    self._stall = 0
        elif self._next < len(self.trace):
            # idle: jump the clock to the next arrival
            self.clock_ms = max(self.clock_ms, self.trace[self._next].t * 1e3)
        return bool(
            self.queue or self.slots.occupied()
            or self._next < len(self.trace)
        )

    def run(self, max_steps: Optional[int] = None) -> TrafficResult:
        """Run until the trace drains (or ``max_steps`` generate steps)."""
        start_steps = self.steps
        while True:
            if (max_steps is not None
                    and self.steps - start_steps >= max_steps):
                break
            if not self.step_once():
                break
        return self.result()

    def result(self) -> TrafficResult:
        return TrafficResult(
            horizon_ms=self.clock_ms,
            steps=self.steps,
            per_class=self.metrics,
            evictions=self.evictions,
            pauses=self.pauses,
            drops=self.drops,
            sheds=self.sheds,
            engine_stats=self.engine.stats(),
        )
