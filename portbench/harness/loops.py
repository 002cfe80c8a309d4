"""The loops that drive the engine: a closed loop of clients and an open
loop of arrivals on the wall clock.  Each records, by host clock, when
every token came back (the end of the step that returned it, which ends
in a device-to-host copy of the tokens) and what each request was served.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, List, Optional

from portbench.harness.traffic import Req


class Driver:
    """One engine and the record of what it served.  ``tracing`` puts
    ``step``/``admit``/``finish`` spans around the calls and tallies each
    traced step's lanes; ``sync`` ends each admission in a synchronize."""

    def __init__(self, eng, clock: Callable[[], float] = time.perf_counter) -> None:
        self.eng = eng
        self.clock = clock
        self.live: Dict[int, Req] = {}  # engine rid -> request
        self.times: Dict[int, List[float]] = collections.defaultdict(list)
        self.served: Dict[int, List[int]] = collections.defaultdict(list)
        self.reqs: Dict[int, Req] = {}
        self.finished: List[int] = []  # request indices, in finishing order
        self.tracing = False
        self.sync: Optional[Callable[[], None]] = None
        self.traced_steps: List[Dict[str, Any]] = []  # positions and wall
        self.traced_admits: List[Dict[str, Any]] = []  # prompt length and wall
        self.failed = 0
        self.refills = 0

    def _span(self, name: str):
        import contextlib

        if not self.tracing:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def admit(self, r: Req) -> None:
        t0 = self.clock()
        with self._span("admit"):
            rid = self.eng.add_request(r.prompt, max_new=r.max_new)
            if self.sync is not None:
                self.sync()
        t1 = self.clock()
        self.live[rid] = r
        self.reqs[r.index] = r
        if self.tracing:
            self.traced_admits.append({"prompt_len": len(r.prompt), "s": t1 - t0})

    def step(self) -> float:
        """One engine step; returns its end time.  Finished requests are
        released (``finish``) right after."""
        positions = None
        if self.tracing:
            positions = [len(r.prompt) - 1 + len(self.served[r.index])
                         for rid, r in self.live.items()
                         if not self.eng.requests[rid].done]
        t0 = self.clock()
        with self._span("step"):
            out = self.eng.step()
        t1 = self.clock()
        if positions is not None:
            self.traced_steps.append({"positions": positions, "s": t1 - t0})
        for rid, tok in out.items():
            idx = self.live[rid].index
            self.served[idx].append(int(tok))
            self.times[idx].append(t1)
        for rid in [rid for rid in self.live if self.eng.requests[rid].done]:
            with self._span("finish"):
                self.eng.finish(rid)
            r = self.live.pop(rid)
            if len(self.served[r.index]) != r.max_new:
                self.failed += 1  # served other than what was asked
            self.finished.append(r.index)
        return t1

    def active(self) -> int:
        return len(self.live)


def refill(drv: Driver, traffic, lanes: int) -> None:
    """Replace each finished request with the next of ``traffic``."""
    while drv.active() < lanes:
        drv.admit(traffic.refill(drv.refills))
        drv.refills += 1


def run_closed(drv: Driver, traffic, lanes: int, t_end: float,
               on_step: Callable[[float], None] = lambda t: None) -> float:
    """Step until the clock passes ``t_end``; each request that finishes
    is replaced at the step boundary.  Returns the end of the last step."""
    while True:
        t = drv.step()
        on_step(t)
        if t >= t_end:
            return t
        refill(drv, traffic, lanes)


def run_open(drv: Driver, arrivals: List[Req], t_open: float, t_end: float,
             lanes: int, on_step: Callable[[float], None] = lambda t: None) -> Dict[int, float]:
    """Admit each request once due (``t_open + due``) and a lane is free,
    in order of arrival, and step while any lane is live, until the clock
    passes ``t_end``.  Returns each request's due time on the clock."""
    pending = collections.deque(sorted(arrivals, key=lambda r: r.due))
    waiting: collections.deque = collections.deque()
    due = {r.index: t_open + r.due for r in arrivals}
    while True:
        now = drv.clock()
        if now >= t_end:
            return due
        while pending and t_open + pending[0].due <= now:
            waiting.append(pending.popleft())
        while waiting and drv.active() < lanes:
            drv.admit(waiting.popleft())
        if drv.active():
            on_step(drv.step())
        else:
            nxt = t_open + pending[0].due if pending else t_end
            time.sleep(max(0.0, min(nxt, t_end) - drv.clock()))
