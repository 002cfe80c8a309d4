"""Serving entry point of the port: batched requests over the TPP-tiered KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --requests 8 --prompt-len 48 --max-new 32

Counterpart of ``repro/launch/serve.py``.  Builds seeded random weights
on the device, drives :class:`repro_torch.serving.ServingEngine` on the
batched data plane (the one that reaches the CUDA kernels) and prints
throughput and placement stats.  Runs on ``--device cuda`` (the
default) or ``cpu``; float32 with TF32 off for matmul and cuDNN.

``--profile DIR`` then traces 16 decode steps with ``torch.profiler``
and prints the device busy time, idle share and top device ops per
step: the breakdown ``PERF.md`` ("Where the time goes") is taken from.
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
from repro_torch.models.model import ModelConfig, init_params
from repro_torch.serving import EngineConfig, ServingEngine


def strict_fp32() -> None:
    """Full float32 matmuls and convolutions: TF32 off for both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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


def profile_decode(eng: ServingEngine, vocab: int, requests: int,
                   prompt_len: int, steps: int, out_dir: str,
                   seed: int = 1) -> Dict[str, Any]:
    """Trace ``steps`` decode steps of a fresh batch with ``torch.profiler``.

    Finishes whatever the engine still holds, admits ``requests`` new
    prompts, runs two untraced warm-up steps, then traces ``steps``
    steps.  Writes the per-op table (``ops.txt``) and a Chrome trace
    (``trace.json``) to ``out_dir`` and returns the wall time and the
    device busy time per step (the sum of kernel times: one stream, so
    kernels do not overlap).  Tracing slows the host; take end-to-end
    times from an untraced run.
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
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        wall = time.perf_counter() - t0
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
    return {
        "traced_steps": steps,
        "wall_ms_per_step": 1e3 * wall / steps,
        "device_busy_ms_per_step": device_us / 1e3 / steps,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "top_device_ops_ms_per_step": {
            e.key: e.self_device_time_total / 1e3 / steps for e in top},
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
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
    ap.add_argument("--profile", metavar="DIR",
                    help="after the timed run, trace 16 decode steps of a "
                         "fresh batch with torch.profiler into DIR")
    args = ap.parse_args()

    from repro_torch.configs import get_config, get_smoke_config

    strict_fp32()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=args.device)
    res = serve(
        cfg, params,
        EngineConfig(
            page_size=args.page_size, num_fast=args.num_fast,
            num_slow=args.num_slow, topk_pages=args.topk_pages,
            max_seqs=max(8, args.requests),
            tpp=TppConfig(demote_budget=64, promote_budget=32),
        ),
        args.requests, args.prompt_len, args.max_new, seed=args.seed,
        device=args.device,
    )
    s = res["stats"]
    print(f"{res['n_tokens']} tokens in {res['steps']} steps on {args.device}: "
          f"{res['tokens_per_s']:.1f} tok/s, {res['ms_per_step']:.2f} ms/step "
          "(float32, TF32 off)")
    print(f"policy=tpp local={s['local_fraction']:.3f} "
          f"demoted={s['demoted']} promoted={s['promoted']} "
          f"migrated={s['migrated_bytes']/1e6:.1f}MB")
    if args.profile:
        prof = profile_decode(res["engine"], cfg.vocab, args.requests,
                              args.prompt_len, 16, args.profile)
        print("profile " + json.dumps(prof))


if __name__ == "__main__":
    main()
