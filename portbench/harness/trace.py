"""The traced run: the harness's own spans around calls into the program's
layers, a ``torch.profiler`` trace of a slice of the window, and its
reduction to device time by span.

Spans (``record_function``, from the harness's files only): ``step``
(``ServingEngine.step``), ``admit`` (``add_request``, the prefill),
``finish``; and, wrapped on the instance in the traced run only,
``policy`` (``policy.step``), ``end_interval`` (``kv.pool.end_interval``),
``flush`` (``kv.flush_migrations``) and ``moe`` (the engine's MoE call).
``portbench.window`` spans the traced slice.

A device operation belongs to a span when the host call that launched
it (the runtime event of the same correlation id) lies inside the span.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("step", "admit", "finish", "policy", "end_interval", "flush", "moe")
# innermost first: what the host was doing during an idle gap
HOST_ORDER = ("flush", "policy", "end_interval", "moe", "admit", "finish", "step")
WINDOW = "portbench.window"


class Intervals:
    """Disjoint, sorted ``[start, end)`` intervals of one span name."""

    def __init__(self, spans: List[Tuple[float, float]]) -> None:
        spans = sorted(spans)
        self.starts = [s for s, _ in spans]
        self.ends = [e for _, e in spans]

    def __contains__(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t < self.ends[i]


class TraceSummary:
    """A reduced trace: the window, device operations with the host time
    that launched them, and the harness's spans (times in µs)."""

    def __init__(self, events: List[Dict[str, Any]]) -> None:
        launch: Dict[int, float] = {}
        spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        ops = []
        for e in events:
            cat = e.get("cat", "")
            if e.get("ph") != "X":
                continue
            corr = (e.get("args") or {}).get("correlation")
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launch[corr] = float(e["ts"])
            elif cat in DEVICE_CATS:
                ops.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0)), corr, cat))
            elif cat == "user_annotation" and (e["name"] in SPANS or e["name"] == WINDOW):
                spans[e["name"]].append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))))
        if not spans.get(WINDOW):
            raise ValueError("the trace holds no window span")
        (w0, w1), = spans.pop(WINDOW)
        self.w0, self.w1 = w0, w1
        self.spans = {n: Intervals(spans.get(n, [])) for n in SPANS}
        # device operations inside the window, each with its launch time
        self.ops = [(n, ts, dur, launch.get(c, ts), cat) for n, ts, dur, c, cat in ops
                    if ts < w1 and ts + dur > w0]

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which any device operation ran."""
        ivs = sorted((max(ts, self.w0), min(ts + d, self.w1)) for _, ts, d, _, _ in self.ops)
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in ivs:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e6

    def idle_by_host(self) -> Dict[str, float]:
        """Idle device seconds by what the host was doing (the innermost
        harness span at the middle of each gap; ``host`` outside them)."""
        ivs = sorted((max(ts, self.w0), min(ts + d, self.w1)) for _, ts, d, _, _ in self.ops)
        out: Dict[str, float] = defaultdict(float)
        t = self.w0
        for s, e in ivs + [(self.w1, self.w1)]:
            if s > t:
                mid = 0.5 * (s + t)
                name = next((n for n in HOST_ORDER if mid in self.spans[n]), "host")
                out[name] += (s - t) / 1e6
            t = max(t, e)
        return dict(out)

    def n_spans(self, name: str) -> int:
        """Spans of ``name`` that lie wholly inside the window."""
        iv = self.spans[name]
        return sum(1 for s, e in zip(iv.starts, iv.ends) if s >= self.w0 and e <= self.w1)

    def span_s(self, name: str) -> float:
        iv = self.spans[name]
        return sum(e - s for s, e in zip(iv.starts, iv.ends)
                   if s >= self.w0 and e <= self.w1) / 1e6

    def device(self, within: Tuple[str, ...] = (), name: Optional[str] = None,
               kernels_only: bool = False) -> Tuple[float, int]:
        """``(seconds, launches)`` of device operations launched inside
        every span of ``within`` and, where given, whose name holds ``name``
        (kernels alone with ``kernels_only``)."""
        secs, n = 0.0, 0
        for op, _, dur, at, cat in self.ops:
            if (name is not None and name not in op) or (kernels_only and cat != "kernel"):
                continue
            if all(at in self.spans[s] for s in within):
                secs += dur
                n += 1
        return secs / 1e6, n

    def top_ops(self, k: int = 10) -> List[List[Any]]:
        by: Dict[str, float] = defaultdict(float)
        for op, _, dur, _, _ in self.ops:
            by[op[:120]] += dur / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def read_chrome_trace(prof) -> List[Dict[str, Any]]:
    """The profiler's events through a Chrome trace in ``TMPDIR``, deleted
    once read."""
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


class Wrapped:
    """Instance-level wrappers that put a span around the program's
    placement, flush and MoE calls; :meth:`undo` restores them."""

    def __init__(self, eng) -> None:
        import torch
        from repro_torch.serving import engine as engine_mod

        self._undo = []

        def wrap(obj, attr, span, on_instance=True):
            fn = getattr(obj, attr)

            def inner(*a, **k):
                with torch.profiler.record_function(span):
                    return fn(*a, **k)

            setattr(obj, attr, inner)
            if on_instance:
                self._undo.append(lambda: delattr(obj, attr))
            else:
                self._undo.append(lambda: setattr(obj, attr, fn))

        wrap(eng.policy, "step", "policy")
        wrap(eng.kv.pool, "end_interval", "end_interval")
        wrap(eng.kv, "flush_migrations", "flush")
        wrap(engine_mod, "moe_fwd", "moe", on_instance=False)

    def undo(self) -> None:
        for f in reversed(self._undo):
            f()
        self._undo = []
