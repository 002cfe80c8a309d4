"""Greedy generation through the model's own ``decode_step``.

    python -m repro_torch.launch.generate --arch deepseek-v2-lite-16b        # on the card
    python -m repro_torch.launch.generate --arch deepseek-v2-lite-16b --smoke --device cpu

``--arch`` takes every ported architecture.  The serving engine pages
the GQA caches of seven of them and refuses MLA, as JAX's does; this
path decodes any of them over the dense caches of ``init_decode_state``
(``repro/models/model.py:271-300``), the decode JAX's dry-run and
``tests/test_models.py`` drive.  Each prompt is fed one token a step
(teacher-forced), then each step feeds back the argmax of the last
logits.  The JAX package has no such launcher; this one only drives
``init_decode_state``, ``decode_step`` and ``forward`` and adds no
arithmetic of its own.  Seeded random weights, float32, TF32 off.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.model import (
    ModelConfig,
    decode_step,
    forward,
    init_decode_state,
    init_params,
)


def make_prompts(cfg: ModelConfig, requests: int, prompt_len: int, seed: int = 0,
                 device="cuda") -> torch.Tensor:
    """Seeded token ids ``(requests, prompt_len)`` (``[, K]`` codebooks)."""
    shape = (requests, prompt_len) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)
    return torch.from_numpy(toks).to(device)


def generate(cfg: ModelConfig, params: Any, prompts: torch.Tensor,
             max_new: int) -> Dict[str, Any]:
    """Feed ``prompts (B, P[, K])`` through ``decode_step`` one token a
    step, then ``max_new`` greedy tokens (``P + max_new - 1`` steps).

    Each step ends in a host read of its tokens, as a server checking for
    an end token would, so ``step_seconds`` are the steps' own wall
    times.  Then one ``forward`` over the prompt and the generated tokens
    scores them: ``score_nll`` is their mean negative log-likelihood.
    """
    device = prompts.device
    B, P = prompts.shape[:2]
    states = init_decode_state(cfg, B, P + max_new, device=device)
    out, finite, secs = [], True, []
    tok = None
    for t in range(P + max_new - 1):
        t0 = time.perf_counter()
        inp = prompts[:, t:t + 1] if t < P else tok[:, None]
        cur = torch.full((B,), t, dtype=torch.int32, device=device)
        logits, states = decode_step(params, cfg, inp, states, cur)
        finite &= bool(torch.isfinite(logits).all())  # the step's host read
        if t >= P - 1:
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)  # (B,) or (B, K)
            out.append(tok.cpu())
        secs.append(time.perf_counter() - t0)
    tokens = torch.stack(out, dim=1)  # (B, max_new[, K])
    seq = torch.cat([prompts, tokens.to(device)], dim=1)
    with torch.no_grad():
        logits, _ = forward(params, cfg, seq[:, :-1])
    logp = torch.log_softmax(logits[:, P - 1:].float(), dim=-1)
    nll = -logp.gather(-1, seq[:, P:].long()[..., None])[..., 0]
    return {"tokens": tokens, "logits_finite": finite, "steps": len(secs),
            "step_seconds": secs,
            "prompt_ms_per_step": 1e3 * statistics.median(secs[:P]),
            "generate_ms_per_step": 1e3 * statistics.median(secs[P:] or secs[-1:]),
            "score_nll": float(nll.mean()),
            "score_finite": bool(torch.isfinite(logits).all())}


def profile_decode_steps(cfg: ModelConfig, params: Any, states: Any, tokens: torch.Tensor,
                         cur: int, steps: int, out_dir: str) -> Dict[str, Any]:
    """Trace ``steps`` ``decode_step`` calls with ``torch.profiler``, fed
    ``tokens (B, 1[, K])`` at positions ``cur, cur + 1, ...`` into
    ``states`` (each call writes its slot: ``cur + steps`` must fit the
    caches).  Writes the per-op table (``ops.txt``) and a Chrome trace
    (``trace.json``) to ``out_dir``; returns per step the wall time, the
    device busy time (the sum of the device events' own time: one
    stream), the idle share, the device launches, the top device ops and
    the port's own kernels in place (launches a step, µs a launch).
    Tracing slows the host; take step times from an untraced run."""
    from torch.profiler import ProfilerActivity, profile

    device = tokens.device
    B = tokens.shape[0]
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            c = torch.full((B,), cur + i, dtype=torch.int32, device=device)
            logits, states = decode_step(params, cfg, tokens, states, c)
            bool(torch.isfinite(logits).all())
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # "Command Buffer Full" is the profiler's record of a full launch
    # queue, not device work
    dev = [e for e in ka if e.device_type.name == "CUDA" and e.key != "Command Buffer Full"]
    busy_us = sum(e.self_device_time_total for e in dev)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "ops.txt").write_text(ka.table(
        sort_by="self_device_time_total" if dev else "self_cpu_time_total", row_limit=40))
    prof.export_chrome_trace(str(out / "trace.json"))
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    top = sorted((e for e in dev if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:10]
    wall_ms, busy_ms = 1e3 * wall / steps, busy_us / 1e3 / steps
    return {"traced_steps": steps, "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_launches_per_step":
                sum(1 for e in events if e.get("cat") == "kernel") / steps,
            "top_device_ops_ms_per_step": {
                e.key: e.self_device_time_total / 1e3 / steps for e in top},
            "port_kernels_in_place": kernel_ops.kernels_in_place(ka, steps)}


def main() -> None:
    from repro_torch.configs import get_config, get_smoke_config, list_archs
    from repro_torch.launch.serve import check_fits, strict_fp32

    ap = argparse.ArgumentParser(description="greedy generation through decode_step")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    strict_fp32()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    check_fits(cfg, args.device)
    params = init_params(cfg, torch.Generator(device=args.device).manual_seed(args.seed),
                         device=args.device)
    prompts = make_prompts(cfg, args.requests, args.prompt_len, args.seed, args.device)
    res = generate(cfg, params, prompts, args.max_new)
    print(f"{res['tokens'].shape[1]} tokens for each of {args.requests} requests in "
          f"{res['steps']} decode steps on {args.device}: "
          f"{res['prompt_ms_per_step']:.2f} ms/step over the prompt, "
          f"{res['generate_ms_per_step']:.2f} ms/step generating (float32, TF32 off)")
    print(f"tokens {res['tokens'].tolist()}")
    print(f"score nll {res['score_nll']:.4f} finite {res['logits_finite']}")


if __name__ == "__main__":
    main()
