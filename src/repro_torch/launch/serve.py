"""Serving entry point of the port: batched requests over the TPP-tiered KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --requests 8 --prompt-len 48 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch phi3.5-moe-42b-a6.6b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --smoke --device cpu --policy autotiering --data-plane reference
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
      --smoke --device cpu

``--arch`` takes each architecture the JAX engine pages: tinyllama-1.1b,
gemma3-4b, phi3-medium-14b, chatglm3-6b, qwen2-vl-2b, musicgen-medium and
phi3.5-moe-42b-a6.6b (``configs.served_archs``).  deepseek-v2-lite-16b's
MLA is refused by both engines; it decodes through
``python -m repro_torch.launch.generate``.

Counterpart of ``repro/launch/serve.py``.  Builds seeded random weights
on the device, drives :class:`repro_torch.serving.ServingEngine` and
prints throughput and placement stats.  ``--policy`` picks TPP or one
of the paper's comparison baselines (``linux``, ``numa_balancing``,
``autotiering``; ``ideal`` gets no slow tier and a fast tier sized to
hold every page of the run).  ``--data-plane`` picks the batched plane
(the default, the one that reaches the CUDA kernels) or the
one-sequence reference plane.  Runs on ``--device cuda`` (the default)
or ``cpu``; float32 with TF32 off for matmul and cuDNN.  A model whose
weights do not fit the card's free memory is refused
(phi3.5-moe-42b-a6.6b at full depth): there is no depth option.

``--profile DIR`` then traces 16 decode steps with ``torch.profiler``
and prints the device busy time, idle share and top device ops per
step: the breakdown ``PERF.md`` ("Where the time goes") is taken from;
``span_host_ms_per_step`` gives the host milliseconds a step in each of
the port's own spans (``repro_torch.spans``: the decode step's phases,
placement, the MoE's stages).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import TppConfig
from repro_torch.kernels import build
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.model import ModelConfig, init_params, param_bytes
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.spans import NAMES as span_names


def strict_fp32() -> None:
    """Full float32 matmuls and convolutions: TF32 off for both, and
    bfloat16 products summed in float32 throughout (no reduced-precision
    reduction), as the CPU's are."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def check_fits(cfg: ModelConfig, device) -> None:
    """Refuse a model whose float32 weights exceed the card's free memory
    (phi3.5-moe-42b-a6.6b at its 32 layers is 167 GB; phi3-medium-14b's
    58.6 GB fit an 80 GB card), rather than cut it silently or fail part
    way through building it."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    need = param_bytes(cfg)
    free, total = torch.cuda.mem_get_info(device)
    if need > free:
        raise SystemExit(
            f"{cfg.name} at {cfg.n_layers} layers needs {need / 1e9:.1f} GB of "
            f"float32 weights; the card has {free / 1e9:.1f} GB free of "
            f"{total / 1e9:.1f} GB.  Run --smoke, or serve fewer layers from a "
            "script (dataclasses.replace(cfg, stacks=((pattern, n),)), as "
            "chip_smoke.py does)."
        )


def pages_needed(requests: int, prompt_len: int, max_new: int,
                 page_size: int) -> int:
    """KV pages a run of ``requests`` prompts decoding ``max_new`` tokens
    reaches: each sequence holds ``prompt_len - 1`` prefilled tokens plus
    one written per decode step."""
    return requests * -(-(prompt_len - 1 + max_new) // page_size)


def ideal_num_fast(pages: int, tpp: TppConfig) -> int:
    """Fewest fast frames that hold ``pages`` pages with every allocation
    above the min watermark (``PagePool.allocate`` keeps ``wm_min``
    frames free): the fast tier of the ``ideal`` baseline, which has no
    slow tier."""
    n = pages + 1
    while n - pages <= tpp.frames(n)[0]:
        n += 1
    return n


def serve(cfg: ModelConfig, params: Any, ecfg: EngineConfig, requests: int,
          prompt_len: int, max_new: int, seed: int = 0,
          device="cuda") -> Dict[str, Any]:
    """Admit ``requests`` random prompts, decode them all to ``max_new``
    tokens; returns tokens, timings and the engine's stats.  On CUDA the
    kernels are built (or loaded) first, outside the timed decode."""
    device = torch.device(device)
    t_build = time.perf_counter()
    if device.type == "cuda":
        build.build()
    t_admit = time.perf_counter()
    eng = ServingEngine(cfg, params, ecfg, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    rids = [eng.add_request(list(rng.integers(0, cfg.vocab, prompt_len)),
                            max_new=max_new)
            for _ in range(requests)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    steps = 0
    while any(not eng.requests[r].done for r in rids):
        eng.step()  # ends in a device→host copy of the step's tokens
        steps += 1
    dt = time.perf_counter() - t0
    toks = sum(len(eng.requests[r].out) for r in rids)
    eng.kv.pool.check_invariants()
    return {
        "engine": eng,
        "tokens": {r: list(eng.requests[r].out) for r in rids},
        "n_tokens": toks,
        "steps": steps,
        "build_s": t_admit - t_build,
        "prefill_s": t0 - t_admit,
        "decode_s": dt,
        "tokens_per_s": toks / dt,
        "ms_per_step": 1e3 * dt / steps,
        "stats": eng.stats(),
    }


def lifecycle_trace(eng: ServingEngine, vocab: int) -> Dict[str, Any]:
    """A scripted pause/resume/finish lifecycle over three requests;
    returns everything observable (the trace of
    ``tests/test_serving_parity.py``, used to hold one run against
    another: the JAX engine, or the same engine on another device)."""
    rng = np.random.default_rng(7)
    rids = [eng.add_request(list(rng.integers(0, vocab, n)), max_new=40)
            for n in (30, 17, 9)]
    tokens, stats = [], []
    for _ in range(6):
        tokens.append(eng.step())
    stats.append(eng.stats())
    eng.pause(rids[0])
    for _ in range(8):
        tokens.append(eng.step())
    stats.append(eng.stats())
    eng.resume(rids[0])
    for _ in range(6):
        tokens.append(eng.step())
    finished = eng.finish(rids[1])
    for _ in range(6):
        tokens.append(eng.step())
    stats.append(eng.stats())
    pages = eng.kv.pool.pages
    tiers = {rid: [int(pages[p].tier) for p in eng.seqs[rid].pages]
             for rid in eng.seqs}
    types = {rid: [int(pages[p].page_type) for p in eng.seqs[rid].pages]
             for rid in eng.seqs}
    eng.kv.pool.check_invariants()
    return {
        "tokens": tokens,
        "stats": stats,
        "finished_out": finished.out,
        "tiers": tiers,
        "types": types,
        "vmstat": eng.kv.pool.vmstat.as_dict(),
    }


def qos_lifecycle_trace(eng: ServingEngine, vocab: int) -> Dict[str, Any]:
    """A scripted two-tenant lifecycle for an engine with QoS armed: a
    latency-critical tenant (0) and a batch tenant (1) fill the fast
    tier, a batch request arrives under that pressure, the batch job
    pauses and finishes, and batch admission is tried again.  Returns
    everything observable, ``stats()["qos"]`` and the steps at which a
    batch request was shed (``AdmissionError`` with reason
    ``"qos_pressure"``) among it.  Duck-typed over the engine, so the
    same script drives the JAX engine."""
    rng = np.random.default_rng(7)
    eng.add_request(list(rng.integers(0, vocab, 30)), max_new=40,
                    qos_class="latency_critical", tenant=0)
    batch = eng.add_request(list(rng.integers(0, vocab, 20)), max_new=40,
                            qos_class="batch", tenant=1)
    tokens, stats, shed, admitted = [], [], [], []

    def try_batch():
        try:
            admitted.append(eng.add_request([1, 2, 3], max_new=4,
                                            qos_class="batch", tenant=1))
        except RuntimeError as exc:  # AdmissionError of either package
            if getattr(exc, "reason", None) != "qos_pressure":
                raise
            shed.append(eng.steps)

    for _ in range(4):
        tokens.append(eng.step())
    try_batch()
    stats.append(eng.stats())
    eng.pause(batch)
    for _ in range(8):
        tokens.append(eng.step())
    try_batch()
    stats.append(eng.stats())
    finished = eng.finish(batch)
    try_batch()
    for _ in range(6):
        tokens.append(eng.step())
    stats.append(eng.stats())
    pages = eng.kv.pool.pages
    eng.kv.pool.check_invariants()
    eng.control.check_consistency(eng.kv.pool)
    return {
        "tokens": tokens,
        "stats": stats,
        "shed_at_steps": shed,
        "admitted": admitted,
        "finished_out": finished.out,
        "tiers": {rid: [int(pages[p].tier) for p in eng.seqs[rid].pages]
                  for rid in eng.seqs},
        "types": {rid: [int(pages[p].page_type) for p in eng.seqs[rid].pages]
                  for rid in eng.seqs},
        "vmstat": eng.kv.pool.vmstat.as_dict(),
    }


def _copy_launches() -> int:
    counts = kernel_ops.launch_counts()
    return counts["page_gather"] + counts["page_scatter"]


def trace_kernel_launches(path) -> int:
    """Device kernel launches in a Chrome trace written by
    ``torch.profiler`` (events of category ``kernel``; copies and fills
    are other categories)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel")


def profile_decode(eng: ServingEngine, vocab: int, requests: int,
                   prompt_len: int, steps: int, out_dir: str,
                   seed: int = 1) -> Dict[str, Any]:
    """Trace ``steps`` decode steps of a fresh batch with ``torch.profiler``.

    Finishes whatever the engine still holds, admits ``requests`` new
    prompts, runs two untraced warm-up steps, then traces ``steps``
    steps.  Writes the per-op table (``ops.txt``) and a Chrome trace
    (``trace.json``) to ``out_dir`` and returns, per step, the wall time,
    the device busy time (the sum of kernel times: one stream, so
    kernels do not overlap), the device kernel launches, the device
    time of the MoE routing stage (route, dispatch and combine), the
    share of the offered expert slots that ``moe_experts`` computed, and
    ``span_host_ms_per_step``: host milliseconds a step inside each of
    the port's spans that the steps recorded (``repro_torch.spans.NAMES``,
    children included).  Tracing slows the host; take end-to-end times
    from an untraced run.
    """
    from torch.profiler import ProfilerActivity, profile

    for rid in list(eng.seqs):
        eng.finish(rid)
    rng = np.random.default_rng(seed)
    for _ in range(requests):
        eng.add_request(list(rng.integers(0, vocab, prompt_len)),
                        max_new=steps + 2)
    for _ in range(2):
        eng.step()
    acts = [ProfilerActivity.CPU]
    if eng.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(eng.device)
    flushes, copies = eng.kv.flushes, _copy_launches()
    experts = kernel_ops.moe_expert_rows()  # reads the card: before the steps
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        wall = time.perf_counter() - t0
    flushes, copies = eng.kv.flushes - flushes, _copy_launches() - copies
    experts = {k: n - experts[k] for k, n in kernel_ops.moe_expert_rows().items()}
    ka = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in ka
                    if e.device_type.name == "CUDA")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "ops.txt").write_text(ka.table(
        sort_by="self_device_time_total" if eng.device.type == "cuda"
        else "self_cpu_time_total", row_limit=40))
    prof.export_chrome_trace(str(out / "trace.json"))
    top = sorted((e for e in ka if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:12]
    own = kernel_ops.kernels_in_place(ka, steps)
    if "page_gather+page_scatter" in own and flushes:
        # by the wrappers' count: the trace can miss a launch
        c = own["page_gather+page_scatter"]
        c.update(flushes=flushes, launches_counted=copies,
                 us_per_flush=c["us_per_launch"] * copies / flushes)
    routing = [own[n]["launches_per_step"] * own[n]["us_per_launch"]
               for n in ("moe_route", "moe_dispatch", "moe_combine") if n in own]
    return {
        "traced_steps": steps,
        "wall_ms_per_step": 1e3 * wall / steps,
        "device_launches_per_step": trace_kernel_launches(out / "trace.json") / steps,
        # the MoE layers' route, dispatch and combine kernels, in place
        "moe_routing_us_per_step": sum(routing) if routing else None,
        # the expert rows moe_experts computed, of the E × C slots offered
        "moe_expert_rows_share": (experts["rows"] / experts["slots"]
                                  if experts["slots"] else None),
        "device_busy_ms_per_step": device_us / 1e3 / steps,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "top_device_ops_ms_per_step": {
            e.key: e.self_device_time_total / 1e3 / steps for e in top},
        "port_kernels_in_place": own,
        "span_host_ms_per_step": {
            e.key: e.cpu_time_total / 1e3 / steps for e in ka if e.key in span_names},
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    from repro_torch.configs import get_config, get_smoke_config, served_archs

    ap.add_argument("--arch", required=True, choices=served_archs())
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-fast", type=int, default=24)
    ap.add_argument("--num-slow", type=int, default=64)
    ap.add_argument("--topk-pages", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", default="tpp",
                    choices=["tpp", "linux", "numa_balancing", "autotiering", "ideal"],
                    help="placement policy; ideal runs with no slow tier and "
                         "a fast tier sized to hold every page of the run")
    ap.add_argument("--data-plane", default="batched", choices=["batched", "reference"])
    ap.add_argument("--profile", metavar="DIR",
                    help="after the timed run, trace 16 decode steps of a "
                         "fresh batch with torch.profiler into DIR")
    args = ap.parse_args()

    strict_fp32()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tpp = TppConfig(demote_budget=64, promote_budget=32)
    num_fast, num_slow = args.num_fast, args.num_slow
    if args.policy == "ideal":
        # the paper's normalisation baseline: every page in the fast tier
        pages = pages_needed(args.requests, args.prompt_len, args.max_new,
                             args.page_size)
        num_fast, num_slow = ideal_num_fast(pages, tpp), 0
        print(f"policy=ideal: num_slow=0, num_fast={num_fast} (the run's "
              f"{pages} pages plus the min watermark's free frames)")
    check_fits(cfg, args.device)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=args.device)
    res = serve(
        cfg, params,
        EngineConfig(
            page_size=args.page_size, num_fast=num_fast,
            num_slow=num_slow, topk_pages=args.topk_pages,
            max_seqs=max(8, args.requests), policy=args.policy,
            data_plane=args.data_plane, tpp=tpp,
        ),
        args.requests, args.prompt_len, args.max_new, seed=args.seed,
        device=args.device,
    )
    s = res["stats"]
    print(f"{res['n_tokens']} tokens in {res['steps']} steps on {args.device}: "
          f"{res['tokens_per_s']:.1f} tok/s, {res['ms_per_step']:.2f} ms/step "
          "(float32, TF32 off)")
    ecfg = res["engine"].ecfg
    print(f"policy={ecfg.policy} data_plane={ecfg.data_plane} "
          f"local={s['local_fraction']:.3f} "
          f"demoted={s['demoted']} promoted={s['promoted']} "
          f"migrated={s['migrated_bytes']/1e6:.1f}MB")
    if args.profile:
        prof = profile_decode(res["engine"], cfg.vocab, args.requests,
                              args.prompt_len, 16, args.profile)
        print("profile " + json.dumps(prof))


if __name__ == "__main__":
    main()
