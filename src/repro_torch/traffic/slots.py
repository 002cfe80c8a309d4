"""The slot engine: JetStream/maxtext-style continuous batching.

Production serving engines (JetStream, maxtext) expose three verbs —
``prefill`` a request into a *prefix* (its prompt KV), ``insert`` that
prefix into a free decode *slot*, and ``generate`` one token for every occupied slot
— so lanes refill independently as sequences hit EOS, instead of the
whole batch draining in lockstep.  :class:`SlotEngine` layers exactly
that API over :class:`~repro_torch.serving.engine.ServingEngine` (a copy
of ``repro/traffic/slots.py``; on the batched plane a generate step runs
the CUDA ``paged_attention`` per layer, and a prefill ``flash_attention``):

* ``prefill`` → ``engine.prefill_request`` — the prompt KV lands in the
  tiered cache **detached** from the decode batch, generating the same
  short-lived hot allocations a running sequence would (the paper's §3
  request-processing pressure) without decoding yet;
* ``insert`` → claims a free lane and ``engine.insert_request`` — a
  double-insert into an occupied lane is a :class:`SlotError` (pinned
  by the lifecycle property tests);
* ``generate`` → one ``engine.step()`` mapped back to slots, with EOS
  detection (``max_new`` reached or an ``eos_id`` token) flagged per
  slot so the caller can release and refill the lane.

The slot engine tracks per-slot stats (insert step, tokens emitted,
last-step tier hit split) but owns no clock — time lives in the
scheduler's latency-accounting model (:mod:`repro_torch.traffic.latency`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.engine import Request, ServingEngine


class SlotError(RuntimeError):
    """Invalid slot-lifecycle transition (double-insert, bad slot id)."""


@dataclasses.dataclass
class SlotInfo:
    """Bookkeeping of one occupied decode lane."""

    slot: int
    rid: int
    tenant: int
    qos_class: str
    inserted_step: int  # engine step count at insert
    tokens: int = 0  # tokens generated in this lane
    paused: bool = False


class SlotEngine:
    """Free-lane tracking + prefill/insert/generate over a ServingEngine."""

    def __init__(self, engine: ServingEngine,
                 eos_id: Optional[int] = None) -> None:
        self.engine = engine
        self.eos_id = eos_id
        self.n_slots = engine.ecfg.max_seqs
        self.lanes: List[Optional[SlotInfo]] = [None] * self.n_slots
        self._slot_of_rid: Dict[int, int] = {}

    # ---------------------------------------------------------------- #
    # lanes
    # ---------------------------------------------------------------- #
    def free_slots(self) -> List[int]:
        """Free decode lanes, lowest first (deterministic refill order)."""
        return [i for i, s in enumerate(self.lanes) if s is None]

    def occupied(self) -> List[SlotInfo]:
        return [s for s in self.lanes if s is not None]

    def slot_of(self, rid: int) -> int:
        return self._slot_of_rid[rid]

    def pages_of(self, slot: int) -> Tuple[int, ...]:
        """Live pids of the lane's sequence (victim-candidate payload)."""
        info = self._occupied_info(slot)
        return tuple(self.engine.seqs[info.rid].pages)

    def _occupied_info(self, slot: int) -> SlotInfo:
        if not 0 <= slot < self.n_slots:
            raise SlotError(f"slot {slot} outside [0, {self.n_slots})")
        info = self.lanes[slot]
        if info is None:
            raise SlotError(f"slot {slot} is not occupied")
        return info

    # ---------------------------------------------------------------- #
    # the three verbs
    # ---------------------------------------------------------------- #
    def prefill(self, prompt: Sequence[int], max_new: int,
                qos_class: str = "standard", tenant: int = 0) -> int:
        """Prefill a request detached from the decode batch → its rid.

        Raises :class:`~repro_torch.serving.engine.AdmissionError` exactly
        like ``add_request`` (max_seqs cap, batch-class QoS shed) — the
        scheduler's admission queue catches and accounts it.
        """
        return self.engine.prefill_request(
            prompt, max_new=max_new, qos_class=qos_class, tenant=tenant
        )

    def insert(self, rid: int, slot: int) -> SlotInfo:
        """Insert a prefilled request into a free decode lane."""
        if not 0 <= slot < self.n_slots:
            raise SlotError(f"slot {slot} outside [0, {self.n_slots})")
        if self.lanes[slot] is not None:
            raise SlotError(
                f"slot {slot} already holds rid {self.lanes[slot].rid}"
            )
        if rid in self._slot_of_rid:
            raise SlotError(
                f"rid {rid} already inserted at slot {self._slot_of_rid[rid]}"
            )
        self.engine.insert_request(rid)  # ValueError if not detached
        seq = self.engine.seqs[rid]
        info = SlotInfo(
            slot=slot, rid=rid, tenant=seq.tenant, qos_class=seq.qos_class,
            inserted_step=self.engine.steps,
        )
        self.lanes[slot] = info
        self._slot_of_rid[rid] = slot
        return info

    def generate(self) -> Dict[int, Tuple[int, bool]]:
        """One decode step for every occupied, unpaused lane.

        Returns ``{slot: (token, done)}``; ``done`` lanes stay occupied
        (holding their KV) until the caller :meth:`release`\\ s them —
        the refill decision belongs to the scheduler.
        """
        toks = self.engine.step()
        out: Dict[int, Tuple[int, bool]] = {}
        for rid, tok in toks.items():
            slot = self._slot_of_rid.get(rid)
            if slot is None:
                continue  # engine-level request outside the slot API
            info = self.lanes[slot]
            info.tokens += 1
            req = self.engine.requests[rid]
            done = req.done or (self.eos_id is not None
                                and tok == self.eos_id)
            if done:
                req.done = True
            out[slot] = (tok, done)
        return out

    # ---------------------------------------------------------------- #
    # lane release / pause
    # ---------------------------------------------------------------- #
    def release(self, slot: int) -> Request:
        """Free a lane: the sequence finishes and its pages free."""
        info = self._occupied_info(slot)
        self.lanes[slot] = None
        del self._slot_of_rid[info.rid]
        return self.engine.finish(info.rid)

    def evict(self, slot: int) -> Request:
        """Preempt a lane under fast-tier pressure (pages free at once).

        Mechanically :meth:`release`; the name marks intent — the
        scheduler re-queues the evicted request for a fresh attempt.
        """
        return self.release(slot)

    def pause(self, slot: int) -> None:
        """Pause a lane: pages retype FILE and demote under pressure."""
        info = self._occupied_info(slot)
        if info.paused:
            raise SlotError(f"slot {slot} is already paused")
        info.paused = True
        self.engine.pause(info.rid)

    def resume(self, slot: int) -> None:
        info = self._occupied_info(slot)
        if not info.paused:
            raise SlotError(f"slot {slot} is not paused")
        info.paused = False
        self.engine.resume(info.rid)

    # ---------------------------------------------------------------- #
    # per-slot residency + stats
    # ---------------------------------------------------------------- #
    def last_hits(self, slot: int) -> Tuple[int, int]:
        """The lane's (fast, slow) tier hit split of the last step."""
        info = self._occupied_info(slot)
        return self.engine.last_hits.get(info.rid, (0, 0))

    def fast_residency(self, slot: int) -> float:
        """Fraction of the lane's pages resident in the fast tier."""
        return self.engine.kv.fast_fraction(self.pages_of(slot))

    def stats(self) -> Dict[str, object]:
        occ = self.occupied()
        return {
            "slots": self.n_slots,
            "occupied": len(occ),
            "paused": sum(1 for s in occ if s.paused),
            "tokens": sum(s.tokens for s in occ),
        }
