"""One run of one cell: set-up, the measured window, the metrics and the
output check.  ``run.py`` calls :func:`run_cell` on the card; the tests
call it on the CPU with a smoke configuration and the plain kernels.
"""

from __future__ import annotations

import gc
import types
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from portbench.harness import spec, stats, traffic, work
from portbench.harness.loops import Driver, refill, run_closed, run_open
from portbench.harness.weights import make_params, plain_layers, port_config


def strict_fp32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN, and no
    reduced-precision sums of bfloat16 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def ideal_num_fast(pages: int, tpp) -> int:
    """Fewest fast frames that hold ``pages`` with every allocation above
    the min watermark (copied from ``launch/serve.py``)."""
    n = pages + 1
    while n - pages <= tpp.frames(n)[0]:
        n += 1
    return n


def tiers(w: Dict[str, Any], tpp) -> Dict[str, int]:
    """Fast and slow frames: the frame space holds every lane at its
    longest context.  ``"tiers": "local"`` puts it all in the fast tier
    (``ideal_num_fast``) with no slow tier; otherwise ``fast_frames`` are
    fast and the slow tier takes the rest plus the min watermark's frames
    that fast allocations leave free."""
    worst = w["lanes"] * traffic.max_pages(w, w["page_size"])
    if w["tiers"] == "local":
        return {"num_fast": ideal_num_fast(worst, tpp), "num_slow": 0}
    fast = w["fast_frames"]
    return {"num_fast": fast, "num_slow": max(0, worst - fast + tpp.frames(fast)[0])}


def counters(eng) -> Dict[str, int]:
    vs = eng.kv.pool.vmstat
    return {"access_fast": vs.access_fast, "access_slow": vs.access_slow,
            "migrated": vs.pgdemote_total + vs.pgpromote_total}


def sample(drv: Driver, n: int, seed: int) -> List[int]:
    """Finished requests to judge, drawn from the seed: the one served
    most tokens and ``n - 1`` others."""
    done = [i for i in drv.finished if i >= 0]
    if not done:
        return []
    longest = max(done, key=lambda i: (len(drv.served[i]), i))
    rest = [i for i in done if i != longest]
    rng = np.random.default_rng([seed, 4])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[int(k)] for k in sorted(pick)]


class Tracing:
    """The traced slice: profiler, harness spans and instance wrappers."""

    def __init__(self, drv: Driver, device: torch.device) -> None:
        from portbench.harness.trace import WINDOW, Wrapped

        self.drv, self.device = drv, device
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.win = torch.profiler.record_function(WINDOW)
        self.win.__enter__()
        self.wrapped = Wrapped(drv.eng)
        drv.tracing = True
        drv.sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else None
        self.summary = None

    def stop(self) -> None:
        from portbench.harness.trace import TraceSummary, read_chrome_trace

        self.drv.tracing = False
        self.drv.sync = None
        self.wrapped.undo()
        self.win.__exit__(None, None, None)
        self.prof.stop()
        self.summary = TraceSummary(read_chrome_trace(self.prof))


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, clock: Callable[[], float],
             dtype=torch.float32) -> Dict[str, Any]:
    """Run ``cell`` once and return its result line as a dict.

    ``dtype`` serves the weights in another type (the lower-precision
    control; the reference stays float32)."""
    from repro_torch.core import TppConfig
    from repro_torch.serving import EngineConfig, ServingEngine

    dev = torch.device(device)
    strict_fp32()
    w = dict(cell.workload)
    window = cell.config.get("sliding_window")
    if window is not None and traffic.max_pages(w, 1) > window:
        raise ValueError(f"{cell.name}: contexts reach {traffic.max_pages(w, 1)} tokens, past "
                         f"the {window}-token window the port does not serve")
    if dev.type == "cuda":
        from repro_torch.kernels import build

        build.build()
    cfg = port_config(cell.config)
    params = make_params(cfg, seed, dev, dtype)
    tpp = TppConfig(demote_budget=w["demote_budget"], promote_budget=w["promote_budget"])
    ecfg = EngineConfig(page_size=w["page_size"], topk_pages=w["topk_pages"],
                        recent_pages=w["recent_pages"], policy="tpp", tpp=tpp,
                        max_seqs=w["lanes"], data_plane="batched", **tiers(w, tpp))
    eng = ServingEngine(cfg, params, ecfg, seed=seed, device=dev)
    drv = Driver(eng, clock)
    vocab = cell.config["vocab_size"]
    lanes = w["lanes"]
    if w["loop"] == "closed":
        closed = traffic.ClosedTraffic(w, seed, vocab)
        for r in closed.snapshot:
            drv.admit(r)
        for _ in range(w["warmup_steps"]):
            drv.step()
            refill(drv, closed, lanes)
    else:
        arrivals = traffic.open_requests(w, seed, vocab, float(seconds))
        for r in traffic.warmup_requests(w, seed, vocab):
            drv.admit(r)
        while drv.active():
            drv.step()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    c0 = counters(eng)
    t_open = clock()
    setup_s = t_open - t_start
    tracing = Tracing(drv, dev) if trace else None
    steps = [0]
    resumed = [t_open]  # when the slice was traced and read, and the loop ran on untraced
    # the slice starts once the profiler has started (its start-up is slow)
    t_trace = clock() + float(w["trace_seconds"])

    def on_step(t: float) -> None:
        steps[0] += 1
        if (tracing is not None and tracing.summary is None and t >= t_trace
                and (w["loop"] == "closed" or len(drv.traced_admits) >= w.get("trace_admits", 0))):
            tracing.stop()
            resumed[0] = clock()

    t_end = t_open + float(seconds)
    if w["loop"] == "closed":
        t1 = run_closed(drv, closed, lanes, t_end, on_step)
        due: Dict[int, float] = {}
    else:
        due = run_open(drv, arrivals, t_open, t_end, lanes, on_step)
        t1 = max(t_end, clock())
    if tracing is not None and tracing.summary is None:
        tracing.stop()
    c1 = counters(eng)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    times = {i: ts for i, ts in drv.times.items() if i >= 0}
    in_window = {i for i, ts in times.items() if any(t_open <= t <= t1 for t in ts)}
    in_window |= {i for i, d in due.items() if t_open <= d <= t1}
    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        metrics = layer_metrics(cell, w, tracing, drv, c0, c1, steps[0],
                                stats.tokens_per_s(times, resumed[0], t1)
                                if t1 > resumed[0] else None)
    else:
        gaps = stats.token_gaps(times, t_open, t1)
        first = {i: ts[0] for i, ts in times.items() if ts}
        e2e = {
            "setup_s": setup_s,
            "decode_tokens_per_s": stats.tokens_per_s(times, t_open, t1),
            "tpot_p95_ms": 1e3 * stats.percentile(gaps, 95) if gaps else None,
            "ttft_p95_ms": (1e3 * stats.percentile(stats.ttfts(due, first, t_open, t1), 95)
                            if due else None),
        }
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    summary = tracing.summary if tracing is not None else None
    # requests due by the close that had not finished: live or waiting
    backlog = (sum(1 for i, d in due.items() if d <= t1) - sum(
        1 for i in drv.finished if i in due)) if due else drv.active()
    # the output check, after the window, with the engine's state freed
    chk = w["check"]
    picked = sample(drv, chk["sample"], seed)
    judged = [(drv.reqs[i].prompt, drv.served[i]) for i in picked]
    failed = drv.failed
    del eng, drv, tracing
    gc.collect()
    if dtype != torch.float32:  # the control: the reference takes float32 weights
        del params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        params = make_params(cfg, seed, dev, torch.float32)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from portbench.reference.model import Model, judge

    ref = Model(cell.config, plain_layers(params, cfg.n_layers))
    verdict = (judge(ref, judged, w["page_size"], w["topk_pages"], w["recent_pages"], dev)
               if judged else {"widest_gap": None, "judged_tokens": 0})
    check = {"widest_gap": {"value": verdict["widest_gap"], "limit": chk["widest_gap"]},
             "judged_tokens": {"value": verdict["judged_tokens"], "limit": chk["min_judged"]}}
    correct = (failed == 0 and verdict["widest_gap"] is not None
               and verdict["widest_gap"] <= chk["widest_gap"]
               and verdict["judged_tokens"] >= chk["min_judged"])
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out: Dict[str, Any] = {"correct": bool(correct), "attempted": len(in_window),
                           "failed": failed, "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info.update(busy_s=summary.busy_s(), window_s=summary.window_s)
        out["breakdown"] = {"device_ops": summary.top_ops(10), "idle_gaps": sorted(
            ([k, v] for k, v in summary.idle_by_host().items()), key=lambda kv: -kv[1])[:10]}
    out["diagnostics"] = {k: verdict[k] for k in verdict if k not in ("widest_gap", "judged_tokens")}
    out["diagnostics"].update(window_s=t1 - t_open, steps=steps[0], judged_requests=len(picked),
                              backlog_at_close=backlog)
    out["check"] = check
    return out


def layer_metrics(cell: spec.Cell, w: Dict[str, Any], tracing: Tracing, drv: Driver,
                  c0: Dict[str, int], c1: Dict[str, int], steps: int,
                  tokens_per_s: Optional[float]) -> Dict[str, Any]:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing leaves its metric out.  ``tokens_per_s`` is the traced
    run's rate, as ``decode_tokens_per_s`` counts it, over the part of the
    window after the slice was traced and read (the reading takes seconds)."""
    ctx = types.SimpleNamespace(
        trace=tracing.summary, steps=drv.traced_steps, admits=drv.traced_admits,
        shapes=work.Shapes.of(cell.config, w["page_size"]), workload=w,
        window_steps=steps, tokens_per_s=tokens_per_s, work=work,
        migrated=c1["migrated"] - c0["migrated"],
        access_fast=c1["access_fast"] - c0["access_fast"],
        access_slow=c1["access_slow"] - c0["access_slow"])
    out: Dict[str, Any] = {}
    for m in cell.per_layer:
        v = spec.metric_reader(m["name"], cell.root)(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
