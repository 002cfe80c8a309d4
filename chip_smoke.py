#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel,
into ``build/``) and runs these phases:

1. **Device** — the card's name and power limit, torch and CUDA
   versions; TF32 off for matmul and cuDNN (float32 throughout).
2. **Kernels** — each of the eight kernels against its plain PyTorch
   version on the card: ``paged_attention`` at the decode shapes of
   tinyllama-1.1b (H=32, Hkv=4, D=64) and phi3.5-moe (H=32, Hkv=8,
   D=128), P=16, B=MP=8, over strided ``store[:, li]`` views, with the
   edges of its split over pages (splits made only of pad pages, a
   window that masks whole splits, pad lanes exactly 0, B=64 where
   there is no split, G=20 over two blocks a head, tiles copied element
   by element) and a long context of MP=64 distinct pages; gather and
   scatter, exact, at both serve paths' frames (tinyllama (22, 4, 16,
   64), phi3.5-moe (8, 8, 16, 128)), over one store and over a (K, V)
   pair, n = 1, 7, 14, 64 and 300 pairs (300 takes two launches), a
   frame that is not a multiple of the kernel's 8 KB chunk, duplicate
   targets with identical payloads, frames on the card refused;
   ``router_topk`` at the MoE serve
   shapes (T=8 decode, T=47 prefill, E=16, k=2), rows of exact ties and
   T=4096, E=64, k=6; the fused MoE routing stage ``moe_route`` (router
   product, top-k, capacity slots, aux in one launch) with phi3.5-moe's
   router (d=4096, E=16, k=2) at decode (C=1, 3 pad lanes), prefill
   (C=7), drop-free capacity, exact ties, T=100 and T=1500 (ragged token
   tiles) and deepseek-v2-lite's router (T=4096, d=2048, E=64, k=6):
   experts, slots, src and counts equal to the plain routing on the
   kernel's own logits, logits within 2e-5 of ``torch.mm``, two runs on
   the same scratch bit for bit, counters back at zero; ``moe_dispatch``
   and ``moe_combine`` equal to their plain versions at each case; one
   full-width phi3.5-moe MoE layer on the card
   against the CPU at its decode and prefill shapes, where experts
   overflow and drop assignments; no launch counted for empty inputs;
   ``flash_attention`` at the two prefill shapes (S=47, causal, through
   the engine's transposed views), S=512, D=64, a ragged S=513, phi3.5's
   heads at S=2048, widths off its templates (D=80, 96) and rows off
   16-byte alignment (the element-by-element loader); plus the
   small sweeps of ``tests/test_kernels.py``.  The five other families
   the engine serves (``FAMILIES``) at their own shapes:
   ``paged_attention`` at each one's decode over its serve store
   (gemma3-4b (8, 8, 256) Hkv=4 with and without its window of 1024,
   phi3-medium (8, 40, 128) Hkv=10, chatglm3 (8, 32, 128) G=16,
   qwen2-vl (8, 12, 128) G=6, musicgen (8, 24, 64) G=1) and at the
   windowed run's block table (2 lanes of 70 pages padded to 128);
   ``flash_attention`` at each one's prefill (S=47) and at the windowed
   run's prompt (S=1099, D=256, window 1024 and none); the copies, exact,
   at each one's frame (458,752 to 4,718,592 B).  The traffic runs' shapes
   (phase 4): ``paged_attention`` with P=4 over a (273, 22, 4, 4, 64)
   store at padded batch 1, 2, 4 × block tables of 2-16 entries, in
   float32 and bfloat16, and the copies, exact, at its 90,112-byte
   frame.  Times each kernel, its
   plain version and, where one exists, the one PyTorch call that
   computes the same function (the copies in phase 6; ``torch.mm`` of
   the router product for the route, beside the unfused chain it
   replaces).
3. **Serve** — full-width tinyllama-1.1b, then full-width phi3.5-moe
   cut to 8 of its 32 layers (42.7 GB of float32 weights), then the
   five ``FAMILIES`` uncut at their published widths (phi3-medium-14b:
   58.6 GB), each with
   seeded random weights through ``ServingEngine`` on ``cuda``: 8
   requests, prompt 48, 32 new tokens each, with demotions and
   promotions.  Launch counts are set to 0 before each run and read
   after it; each kernel of the path must have launched exactly as
   often as the path calls it (the copies once a flush and once for the
   cache's prewarm; route, dispatch and combine once an MoE layer a
   forward, the unfused ``router_topk`` never), and placement must
   equal ``PLACEMENT``.  The
   cache's histogram of pairs per flush is kept.  Then 8 decode steps
   of a fresh batch are traced with ``torch.profiler`` (device busy time,
   idle share, kernel launches and the MoE routing stage's time per
   step, top device ops; trace in ``build/profile/<arch>/``).  Then the
   paper's comparison at full width: tinyllama-1.1b at the same serve
   config under ``linux``, ``numa_balancing`` and ``autotiering``, and
   under ``ideal`` with no slow tier and a fast tier that holds every
   page, each with exact launch counts and its policy's semantics
   (``linux`` never migrates, ``numa_balancing`` never demotes,
   ``autotiering`` demotes and promotes, ``ideal`` never reads the slow
   tier).  Then the reference data plane at full width (2 requests,
   prompt 48, 8 new tokens): no ``paged_attention`` and no copy launch,
   and tokens equal to the batched plane's on the same inputs in every
   request, but for at most one request that may differ from a logged
   near-tie on (top-2 logit gap below ``NEAR_TIE``).  Then the same
   two planes serve full-width gemma3-4b on prompts of 1100 tokens, past
   its local layers' window of 1024, with exact attention, 48 fast and
   128 slow frames (2 requests × 16 tokens): the first serve run whose
   window masks, with tokens equal between the planes under the same
   near-tie rule and placement equal to ``WINDOWED_PLACEMENT``.  Last, with
   ``TIERSAN_LEVEL=full`` and ``TIERSAN_PLAN_CHECK=1``, scripted
   smoke-size lifecycles run on ``cuda`` and on ``cpu``: all seven archs
   on both planes, tinyllama under each baseline, and a two-tenant QoS
   lifecycle that must shed a batch request; tokens, stats (with
   ``stats()["qos"]``), VmStat, tiers and page types must be equal.
4. **Traffic** — the continuous-batching front end
   (``repro_torch.traffic``) over full-width tinyllama-1.1b with the
   traffic benchmark's engine (16 fast, 256 slow frames of 4 tokens,
   4 lanes, QoS): Poisson and MMPP traces of 56 requests × relief
   ``shed`` and ``control`` with exact attention, each summary and
   placement equal to the smoke config's run of the same trace on the
   CPU, with exact launch counts; the Poisson/``control`` trace at the
   benchmark's top-4 pages on both planes, tokens equal; a cuda-vs-cpu
   smoke lifecycle of the scheduler under ``TIERSAN_LEVEL=full`` that
   ends with every frame free; the card's wall times and a profile of
   8 generate steps (``measured``), apart from the scheduler's modeled
   TTFT and TPOT (``modeled_ms``).
   Then (``[fleet]``) a fleet of two such full-width engines on phase 4's
   weights, one KV shard each (``ServingEngine.as_shard_pool`` with the
   scheduler driving the shard): host 0 serves the MMPP trace, host
   1 the Poisson one, 56 requests each, relief ``shed``, under one
   ``FleetCoordinator`` with a global budget of 24 of their 32 fast
   frames and the fleet mesh (``use_mesh``) over a 2-rank ``gloo``
   group.  ``greedy`` pushes the capacity-proportional split once;
   ``coordinated`` ticks the coordinator after every 16 generate steps
   of each host until both schedulers drain.  Each mode's
   ``coordinator.summary()``, each scheduler's summary and engine stats
   equal the same fleet's on the CPU at the smoke config (completions
   by request and length: the tokens follow the weights); budgets are
   conserved after every push, a coordinated tick moves a budget off
   the greedy split, each tick's mesh reduction returns the numpy sum,
   launch counts are exact over both engines, the pools pass
   ``check_invariants``; the wall seconds, ms per generate per host and
   the flush histogram are printed.
5. **Expert tier** — ``repro_torch.serving.expert_tier`` at phi3.5-moe's
   published expert widths (314,572,800 B an expert): 51 of 8 × 16
   experts in an HBM bank, all of them in a pinned host bank, on the
   expert-tiering benchmark's stream under ``linux``, ``autotiering``
   and ``tpp``; counts equal to the CPU's and ``EXPERT_COUNTS``, every
   expert bit for bit after the migrations, the host link's rates and
   the lookups timed.  After ``tpp`` the manager joins a one-shard fleet
   (``as_shard_pool(host=2)``, a global budget of 80% of its HBM
   experts, ``min_budget`` 8) and the stream runs 40 more steps: counts
   equal to a CPU manager's at tiny widths under the same push-down,
   every expert bit for bit again.
6. **Copies** — ``page_gather`` and ``page_scatter`` timed at each of the
   seven serve runs' and the traffic runs' median flush (pairs × both
   stores, at its frame) and at 64 live frames of one store, beside
   their plain versions, the library
   calls (``index_select`` / ``index_copy_`` once per store) and the
   bytes bound; and one gather then scatter, as a flush runs them.

Then (``[train]``) the training path: ``moe_combine_bwd`` against its
plain version (``dye`` bit for bit, ``dvals`` within ``DVALS_REL``) at
phi3.5-moe's training shape (T=2048, C=320) and decode shape with tokens
dropped, deepseek-v2-lite's router shape and hand-made edges (empty
slots, a token whose gates all drop, d=70), with the dispatch's backward
(``moe_combine`` with unit gates), each timed beside its plain version
and bound, and the route's backward timed; one phi3.5-moe layer at
published widths, every gradient through the kernels' autograd within
``TRAIN_GRAD_REL`` of the plain versions' and of plain autograd, at
T=2048 (dropping) and decode; cuda == cpu for three ``make_train_step``
steps (plain, ``accum=2``, ``remat=True``) of all seven archs' smoke
configs, within ``TRAIN_SMOKE_TOL``, MoE launches exact (remat runs each
MoE layer's forward twice); full-width tinyllama-1.1b through
``train_loop`` at B=8, S=256, 8 steps with a checkpoint every 4 into
``build/train_ckpt``, the loss falling, a relaunch from step 4 equal to
the uninterrupted run bit for bit (deterministic algorithms), the same
run with a third of the optimizer state's bytes kept on the card and the
rest in pinned host memory, 4 steps bit for bit equal, the host link's
rates, and 2 traced steps; full-width phi3.5-moe cut to 2 of 32 layers,
4 steps at B=8, S=256 with exact launches (route, dispatch and combine
once an MoE layer a forward, the combine once more and
``moe_combine_bwd`` once an MoE layer a backward) and 2 traced steps.

Prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power
line, and last ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero before the result lines; there is no CPU fallback.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS = 8  # of 32: 42.7 GB of float32 weights on an 80 GB card
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
# H100 SXM peak FLOP/s by input type, NVIDIA data sheet, dense: float32
# outside the tensor cores, bfloat16 on them
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:18
# each serve run's placement: the same for both archs, and the port's
# kernels must not change it
PLACEMENT = {"local_fraction": 0.6205357142857143, "demoted": 208, "promoted": 205}
BASELINES = ("linux", "numa_balancing", "autotiering", "ideal")
# the other families the JAX engine pages, served uncut at their
# published widths at the same config as tinyllama-1.1b
FAMILIES = ("gemma3-4b", "phi3-medium-14b", "chatglm3-6b", "qwen2-vl-2b",
            "musicgen-medium")
# the windowed run: gemma3-4b's prompts outgrow its local layers' window of
# 1024, with exact attention (every page attended, no page-score ties)
WINDOWED_ARCH = "gemma3-4b"
WINDOWED = {"requests": 2, "prompt_len": 1100, "max_new": 16}
# its placement: every page of both sequences is touched every step, so it
# depends on no weight (the smoke config gives the same on the CPU)
WINDOWED_PLACEMENT = {"local_fraction": 0.3249551166965889, "demoted": 484,
                      "promoted": 480}
# the reference plane's tokens may differ from the batched plane's only
# where the reference logits' top two are closer than this
NEAR_TIE = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_usage(text: str):
    """``(function, registers, spills)`` for each kernel in ``nvcc
    -Xptxas=-v`` output, names demangled where ``c++filt`` is found."""
    import shutil

    out, fn, spills = [], "?", ""
    for line in text.splitlines():
        line = line.strip()
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif "spill" in line:
            spills = line
        elif "registers" in line:
            out.append([fn, line.split(":", 1)[-1].strip(), spills])
            fn, spills = "?", ""
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in out),
                               capture_output=True, text=True, timeout=60).stdout
        for r, name in zip(out, names.splitlines()):
            r[0] = name
    return [tuple(r) for r in out]


# --------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------- #
LEAD_CYCLES = 2_000_000  # about 1 ms of spinning at the H100's clock


def time_ms(torch, fn, flush, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time of one call with a cold L2 (the decode step
    streams ~46 MB of FFN weights between attention layers, so the store
    is cold when the kernel runs).

    Before each call the card reads the whole ``flush`` buffer (256 MB, a
    sum into one element), which leaves L2 full of clean lines: writing
    the buffer instead would leave dirty lines whose write-back runs
    inside the timed call.  Then it spins for ``LEAD_CYCLES`` (a kernel
    that touches no memory) while the host queues the call, so the
    interval between the events holds the call's device work and not
    the host's Python and launch overhead.
    """
    sink = torch.empty((), dtype=flush.dtype, device=flush.device)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        torch.sum(flush, dim=0, out=sink)
        torch.cuda._sleep(LEAD_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound(nbytes: float, flops: float, dtype: str = "float32"):
    """Least time in ms for ``nbytes`` of HBM traffic and ``flops`` on
    inputs of ``dtype``, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------- #
def attn_case(torch, gen, B, H, Hkv, P, MP, D, F, L, dtype, window, pad_lanes,
              pad_tail=1, distinct=False, stores=None):
    """Random position-mode inputs over an (F, L, Hkv, P, D) store: the
    last ``pad_tail`` entries of each lane are pad entries on the trash
    frame; ``distinct`` gives every entry its own frame.  ``stores``, a
    (K, V) pair of that shape and ``dtype``, is used instead of new ones."""
    from repro_torch.kernels.paged_attention import PAD_PAGE_POS

    dev = "cuda"
    if stores is None:
        stores = tuple(torch.randn((F, L, Hkv, P, D), generator=gen, device=dev).to(dtype)
                       for _ in range(2))
    store_k, store_v = stores
    q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype)
    trash = F - 1
    if distinct:
        bt = torch.randperm(F - 1, generator=gen, device=dev)[:B * MP]
        bt = bt.view(B, MP).to(torch.int32)
    else:
        bt = torch.randint(0, F - 1, (B, MP), generator=gen, device=dev).to(torch.int32)
    ps = (torch.arange(MP, device=dev, dtype=torch.int32) * P).expand(B, MP).clone()
    q_pos = torch.full((B,), (MP - pad_tail + 1) * P - 3, dtype=torch.int32, device=dev)
    ps[:, MP - pad_tail:] = PAD_PAGE_POS  # pad entries at the end of each lane
    bt[:, MP - pad_tail:] = trash
    for b in range(B - pad_lanes, B):  # fully masked pad lanes
        bt[b] = trash
        ps[b] = PAD_PAGE_POS
        q_pos[b] = 0
    li = L // 2 if L > 1 else 0
    return dict(q=q, k_pages=store_k[:, li], v_pages=store_v[:, li],
                block_table=bt, page_pos=ps, q_pos=q_pos, window=window)


def attn_work(torch, case):
    """Bytes and FLOPs this call's data needs: each referenced page with a
    valid slot read once (K and V, every KV head), q read, out written."""
    q, kp = case["q"], case["k_pages"]
    B, H, D = q.shape
    _, Hkv, P, _ = kp.shape
    bt = case["block_table"].cpu()
    ps = case["page_pos"].cpu().long()
    qp = case["q_pos"].cpu().long()[:, None, None]
    pos = ps[:, :, None] + torch.arange(P)[None, None, :]
    valid = pos <= qp
    if case["window"] is not None:
        valid &= pos > qp - case["window"]
    frames = set(bt[valid.any(dim=2)].tolist())
    n_valid = int(valid.sum())
    item = kp.element_size()
    nbytes = (len(frames) * 2 * Hkv * P * D * item + 2 * B * H * D * item
              + bt.numel() * 8 + B * 4)
    flops = 4.0 * n_valid * (H // Hkv) * Hkv * D
    return nbytes, flops


def check_paged_attention(torch, gen, F, L, moe_L, flush, fails, families, windowed):
    """``families``: name → config of each family served in phase 3, checked
    and timed at its decode shape over its serve store (every window its
    layers use); ``windowed``: ``(name, cfg, F, MP, pages)`` of the
    windowed run, checked and timed at its block table."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import paged_attention as pa

    checks = []

    def run(name, case, dtype, exact_zero_rows=0):
        got = ops.paged_attention(**case, impl="kernel")
        torch.cuda.synchronize()
        want = ops.paged_attention(**case, impl="ref")
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
        if exact_zero_rows:
            ok &= bool((got[-exact_zero_rows:] == 0).all())
        checks.append({"case": name, "dtype": dtype, "max_abs_err": err,
                       "tolerance": TOL[dtype], "ok": ok})
        if not ok:
            fails.append(f"paged_attention {name} {dtype}: max_abs_err {err}")

    def plan(case):
        B, H, _ = case["q"].shape
        _, Hkv, _, _ = case["k_pages"].shape
        GC, NW, NS, pps = pa.split_plan(B, Hkv, H // Hkv, case["block_table"].shape[1],
                                        build.sm_count("cuda"))
        return f"NS={NS} pps={pps}"

    main = long_ctx = ns1 = None
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for window in (None, 40):
            case = attn_case(torch, gen, 8, 32, 4, 16, 8, 64, F, L, dtype,
                             window, pad_lanes=2)
            # the last entry is a pad page: its split (one page) is pad only;
            # the window of 40 masks the first five splits whole
            run(f"main B=8 MP=8 F={F} L={L} window={window} {plan(case)} "
                f"(pad-only split{', whole splits masked by the window' if window else ''})",
                case, dtype_name, exact_zero_rows=2)
            if dtype_name == "float32" and window is None:
                main = case
        # splits of several pages, the last two of them pad only
        case = attn_case(torch, gen, 8, 32, 4, 16, 32, 64, F, 1, dtype, None,
                         pad_lanes=1, pad_tail=4)
        run(f"B=8 MP=32 {plan(case)} last 4 entries pad (a pad-only split)",
            case, dtype_name, exact_zero_rows=1)
        # B·Hkv = 256 blocks: no split, out written directly
        case = attn_case(torch, gen, 64, 32, 4, 16, 8, 64, F, L, dtype, None,
                         pad_lanes=3)
        run(f"B=64 MP=8 {plan(case)} (no split)", case, dtype_name, exact_zero_rows=3)
        if dtype_name == "float32":
            ns1 = case
        # long context: 64 distinct pages of 16 tokens over a one-layer store
        # of 1025 frames (32 MB of K and V in float32)
        case = attn_case(torch, gen, 8, 32, 4, 16, 64, 64, 1025, 1, dtype, None,
                         pad_lanes=1, pad_tail=1, distinct=True)
        run(f"long context B=8 MP=64 F=1025 L=1 {plan(case)}", case, dtype_name,
            exact_zero_rows=1)
        if dtype_name == "float32":
            long_ctx = case
    # phi3.5-moe's decode shape: Hkv=8, G=4, D=128 over its 8-layer store
    moe = attn_case(torch, gen, 8, 32, 8, 16, 8, 128, F, moe_L, torch.float32,
                    None, pad_lanes=2)
    run(f"phi3.5-moe decode B=8 MP=8 Hkv=8 D=128 F={F} L={moe_L} {plan(moe)}", moe,
        "float32", exact_zero_rows=2)
    # G = 20 > 16 (two blocks per KV head), P = 12 and D = 48 (idle lanes);
    # P = 3, D = 18: tiles not 16-byte aligned, copied element by element
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for (B, H, Hkv, P, MP, D, window) in [(3, 40, 2, 12, 6, 48, 30),
                                              (2, 6, 3, 3, 7, 18, None)]:
            case = attn_case(torch, gen, B, H, Hkv, P, MP, D, 40, 2, dtype, window,
                             pad_lanes=1)
            run(f"B={B} H={H} Hkv={Hkv} P={P} MP={MP} D={D} window={window} "
                f"{plan(case)}", case, dtype_name, exact_zero_rows=1)
    # the small sweeps of tests/test_kernels.py (length mode)
    for (B, H, Hkv, P, MP, D) in [(2, 4, 2, 8, 4, 32), (1, 8, 8, 16, 3, 64),
                                  (3, 4, 1, 8, 5, 16), (1, 16, 4, 32, 2, 128)]:
        for dtype_name, dtype in (("float32", torch.float32),
                                  ("bfloat16", torch.bfloat16)):
            q = torch.randn((B, H, D), generator=gen, device="cuda").to(dtype)
            kp = torch.randn((24, Hkv, P, D), generator=gen, device="cuda").to(dtype)
            vp = torch.randn((24, Hkv, P, D), generator=gen, device="cuda").to(dtype)
            bt = torch.randint(0, 24, (B, MP), generator=gen,
                               device="cuda").to(torch.int32)
            lengths = torch.randint(1, MP * P + 1, (B,), generator=gen,
                                    device="cuda").to(torch.int32)
            run(f"length B={B} H={H} Hkv={Hkv} P={P} MP={MP} D={D}",
                dict(q=q, k_pages=kp, v_pages=vp, block_table=bt,
                     lengths=lengths), dtype_name)
            if dtype_name == "float32":  # length ≡ position on a dense prefix
                ps = (torch.arange(MP, device="cuda", dtype=torch.int32) * P
                      ).expand(B, MP).contiguous()
                o_len = ops.paged_attention(q, kp, vp, bt, lengths, impl="kernel")
                o_pos = ops.paged_attention(q, kp, vp, bt, page_pos=ps,
                                            q_pos=lengths - 1, impl="kernel")
                torch.cuda.synchronize()
                if not torch.equal(o_len, o_pos):
                    fails.append(f"paged_attention length != position mode "
                                 f"at B={B} H={H} P={P} MP={MP} D={D}")

    def timed(case):
        args = (case["q"], case["k_pages"], case["v_pages"], case["block_table"])
        kw = dict(page_pos=case["page_pos"], q_pos=case["q_pos"], window=case["window"])
        nbytes, flops = attn_work(torch, case)
        b_ms, b_by = bound(nbytes, flops, str(case["q"].dtype).removeprefix("torch."))
        return dict(
            kernel_ms=time_ms(torch, lambda: pa.paged_attention(*args, **kw), flush),
            plain_ms=time_ms(torch, lambda: pa.paged_attention_plain(*args, **kw), flush),
            bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes, bound_flops=flops)

    # each family's decode at batch 8 over its serve store, P=16, MP=8,
    # 2 pad lanes; a windowed family with and without its window
    fam, first = {}, None
    for fname, fcfg in families.items():
        a = fcfg.all_specs()[0].attn
        H, Hkv, D, FL = a.n_heads, a.n_kv_heads, a.head_dim, fcfg.n_layers
        for window in sorted({s.attn.window for s in fcfg.all_specs()},
                             key=lambda w: w or 0):
            case = attn_case(torch, gen, 8, H, Hkv, 16, 8, D, F, FL, torch.float32,
                             window, pad_lanes=2)
            shape = (f"q (8, {H}, {D}) f32, G={H // Hkv}, store[:, li] of (F={F}, "
                     f"L={FL}, {Hkv}, 16, {D}), block table (8, 8), window={window}, "
                     "2 pad lanes")
            run(f"{fname} decode {shape} {plan(case)}", case, "float32",
                exact_zero_rows=2)
            key = fname + (f" window={window}" if window else "")
            fam[key] = dict(timed(case), plan=plan(case), shape=shape)
            first = first or (key, case)
            del case
    # the first family case timed once more after the others: in whole
    # runs of this script on an H100 80GB HBM3 (700 W) its first reading
    # came out at 40-58 us, against 15.5 for the same call with a window
    # that masks nothing (PERF.md, open questions)
    key, case = first
    fam[key]["repeat"] = timed(case)
    del first, case
    # the windowed run: 2 lanes whose block tables hold every page (exact
    # attention) padded to the bucket; the window masks the first pages
    wname, wcfg, wF, wMP, wpages = windowed
    a = wcfg.all_specs()[0].attn
    for window in (a.window, None):
        case = attn_case(torch, gen, 2, a.n_heads, a.n_kv_heads, 16, wMP, a.head_dim,
                         wF, wcfg.n_layers, torch.float32, window, pad_lanes=0,
                         pad_tail=wMP - wpages)
        shape = (f"q (2, {a.n_heads}, {a.head_dim}) f32, store[:, li] of (F={wF}, "
                 f"L={wcfg.n_layers}, {a.n_kv_heads}, 16, {a.head_dim}), block table "
                 f"(2, {wMP}) with {wpages} pages, q_pos {int(case['q_pos'][0])}, "
                 f"window={window}")
        run(f"{wname} windowed run {shape} {plan(case)}", case, "float32")
        fam[f"{wname} windowed run window={window}"] = dict(
            timed(case), plan=plan(case), shape=shape)
        del case

    t = timed(main)
    # the same call with L2 warm (no flush), and the floor of this timing:
    # one float filled, timed the same way
    warm = torch.ones(1, device="cuda")
    args = (main["q"], main["k_pages"], main["v_pages"], main["block_table"])
    kw = dict(page_pos=main["page_pos"], q_pos=main["q_pos"])
    t["warm_l2_ms"] = time_ms(torch, lambda: pa.paged_attention(*args, **kw), warm)
    one = torch.empty(1, device="cuda")
    t["timing_floor_ms"] = time_ms(torch, lambda: one.fill_(1.0), flush)
    f32 = [c for c in checks if c["dtype"] == "float32"]
    return {
        "name": "paged_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:195",
        "shape": "q (8, 32, 64) f32, store[:, li] of (F=%d, L=%d, 4, 16, 64), "
                 "block table (8, 8), position mode, 2 pad lanes" % (F, L),
        "max_abs_err": max(c["max_abs_err"] for c in f32),
        "tolerance": TOL["float32"],
        "max_abs_err_bf16": max(c["max_abs_err"] for c in checks
                                if c["dtype"] == "bfloat16"),
        "tolerance_bf16": TOL["bfloat16"],
        **t,
        "library_ms": None,
        "plan": plan(main),
        "phi3_5_moe_decode": dict(
            timed(moe), plan=plan(moe), shape="q (8, 32, 128) f32, store[:, li] of "
            f"(F={F}, L={moe_L}, 8, 16, 128), block table (8, 8), 2 pad lanes"),
        "no_split_B64": dict(
            timed(ns1), plan=plan(ns1), shape="q (64, 32, 64) f32, store[:, li] of "
            f"(F={F}, L={L}, 4, 16, 64), block table (64, 8), 3 pad lanes"),
        "long_context_MP64": dict(
            timed(long_ctx), plan=plan(long_ctx), shape="q (8, 32, 64) f32, store "
            "(1025, 1, 4, 16, 64), block table (8, 64) of distinct frames, "
            "1 pad entry a lane, 1 pad lane"),
        "families": fam,
        "checks": len(checks),
    }


def check_traffic_attention(torch, gen, F, cfg, page_size, flush, fails):
    """``paged_attention`` at the traffic runs' decode shapes: tinyllama's
    heads over a store of ``F`` frames of ``page_size`` tokens (P=4 takes
    the ``P <= 8`` template), padded batch B in {1, 2, 4} (one pad lane
    at B=4, the engine's bucket of 3 lanes) × block-table width MP in
    {2, 4, 8, 16}, one pad entry a lane; float32 and bfloat16 against the
    plain version, pad rows exactly 0.  Returns each float32 case's
    times beside its bound and plain time, and the largest errors."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import paged_attention as pa

    a = cfg.all_specs()[0].attn
    H, Hkv, D, L = a.n_heads, a.n_kv_heads, a.head_dim, cfg.n_layers
    errs = {"float32": 0.0, "bfloat16": 0.0}
    times = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        stores = tuple(torch.randn((F, L, Hkv, page_size, D), generator=gen,
                                   device="cuda").to(dtype) for _ in range(2))
        for B in (1, 2, 4):
            pad = 1 if B == 4 else 0
            for MP in (2, 4, 8, 16):
                case = attn_case(torch, gen, B, H, Hkv, page_size, MP, D, F, L, dtype,
                                 None, pad_lanes=pad, stores=stores)
                got = ops.paged_attention(**case, impl="kernel")
                torch.cuda.synchronize()
                want = ops.paged_attention(**case, impl="ref")
                err = (got.float() - want.float()).abs().max().item()
                ok = bool(torch.isfinite(got).all()) and torch.allclose(
                    got.float(), want.float(), atol=TOL[dtype_name], rtol=TOL[dtype_name])
                if pad:
                    ok &= bool((got[-pad:] == 0).all())
                errs[dtype_name] = max(errs[dtype_name], err)
                NS = pa.split_plan(B, Hkv, H // Hkv, MP, build.sm_count("cuda"))[2]
                name = f"Bp={B} MP={MP} P={page_size} pad_lanes={pad} NS={NS}"
                if not ok:
                    fails.append(f"paged_attention traffic {name} {dtype_name}: "
                                 f"max_abs_err {err}")
                if dtype_name == "float32":
                    args = (case["q"], case["k_pages"], case["v_pages"], case["block_table"])
                    kw = dict(page_pos=case["page_pos"], q_pos=case["q_pos"])
                    nbytes, flops = attn_work(torch, case)
                    b_ms, b_by = bound(nbytes, flops)
                    times[name] = dict(
                        kernel_ms=time_ms(torch, lambda: pa.paged_attention(*args, **kw),
                                          flush),
                        plain_ms=time_ms(torch, lambda: pa.paged_attention_plain(
                            *args, **kw), flush),
                        bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes)
                del case
        del stores
    out = {"shape": f"q (Bp, {H}, {D}) f32, store[:, li] of (F={F}, L={L}, {Hkv}, "
                    f"{page_size}, {D}), block table (Bp, MP), position mode",
           "max_abs_err": errs["float32"], "max_abs_err_bf16": errs["bfloat16"],
           "checks": 2 * len(times), **times}
    log(f"[kernels] paged_attention at the traffic shapes {json.dumps(out)}")
    return out


def frame_shape(cfg, ecfg):
    """One frame of the engine's KV store: ``(L, Hkv, P, D)``."""
    a = cfg.all_specs()[0].attn
    return (cfg.n_layers, a.n_kv_heads, ecfg.page_size, a.head_dim)


def check_page_migrate(torch, gen, F, frame, fails, sweeps=True):
    """Gather and scatter of ``frame = (L, Hkv, P, D)`` frames over one store
    and over a (K, V) pair of stores of ``F`` frames (more where a case
    needs more distinct frames), against ``index_select``/``index_copy_``:
    exact, for n = 1, 7, 14, 64 and 300 pairs (300 takes two launches of
    ``MAX_PAIRS``), a frame size that is not a multiple of the kernel's
    8 KB chunk, duplicate targets with identical payloads, frames on the
    card refused; ``sweeps`` adds the small round trips of
    ``tests/test_kernels.py``.  Returns the number of checks."""
    from repro_torch.kernels import ops

    checks = 0

    def host(t):
        return t.to(device="cpu", dtype=torch.int32)

    def run(name, stores, src, dst):
        """One gather of ``src`` and one scatter of it into ``dst`` (host
        int32 frames), kernel against plain, exact."""
        nonlocal checks
        one = len(stores) == 1
        arg = stores[0] if one else tuple(stores)
        g = ops.page_gather(arg, src, impl="kernel")
        torch.cuda.synchronize()
        g_ref = ops.page_gather(arg, src, impl="ref")
        outs = [s.clone() for s in stores]
        refs = [s.clone() for s in stores]
        ops.page_scatter(outs[0] if one else tuple(outs), dst, g, impl="kernel")
        torch.cuda.synchronize()
        ops.page_scatter(refs[0] if one else tuple(refs), dst, g_ref, impl="ref")
        checks += 2
        if not torch.equal(g, g_ref):
            fails.append(f"page_gather {name} differs from index_select: "
                         f"{(g - g_ref).abs().max().item()}")
        if not all(torch.equal(a, b) for a, b in zip(outs, refs)):
            fails.append(f"page_scatter {name} differs from index_copy_")

    for n in (1, 7, 14, 64, 300):
        Fn = max(F, n + 1)  # distinct targets: 300 pairs need 301 frames
        stores = [torch.randn((Fn,) + tuple(frame), generator=gen, device="cuda")
                  for _ in range(2)]
        src = host(torch.randperm(Fn - 1, generator=gen, device="cuda")[:n])
        dst = host(torch.randperm(Fn - 1, generator=gen, device="cuda")[:n])
        for S in (1, 2):
            run(f"frame {tuple(frame)} n={n} stores={S} F={Fn}", stores[:S], src, dst)
        del stores
    # a frame of four 8 KB chunks and a 48-byte tail
    tail = [torch.randn((40, 2 * 4096 + 12), generator=gen, device="cuda")
            for _ in range(2)]
    src = host(torch.randperm(39, generator=gen, device="cuda")[:14])
    dst = host(torch.randperm(39, generator=gen, device="cuda")[:14])
    run("frame of 32,816 B (4 chunks + 48 B) n=14 stores=2", tail, src, dst)
    # duplicate targets with identical payloads: trash-frame self-copies
    stores = [torch.randn((F,) + tuple(frame), generator=gen, device="cuda")
              for _ in range(2)]
    trash = F - 1
    src = torch.tensor([2, 5] + [trash] * 5, dtype=torch.int32)
    dst = torch.tensor([6, 1] + [trash] * 5, dtype=torch.int32)
    run(f"frame {tuple(frame)} duplicate trash targets stores=2", stores, src, dst)
    # frames on the card would need a device->host sync: refused
    try:
        ops.page_gather(tuple(stores), src.cuda(), impl="kernel")
        fails.append("page_gather took frames on the card")
    except ValueError:
        checks += 1
    del stores
    # small sweeps of tests/test_kernels.py:123-141
    for n, f, seed in [(1, 8, 0), (4, 16, 7), (8, 24, 42), (5, 23, 31)] if sweeps else []:
        g = torch.Generator(device="cuda").manual_seed(seed)
        s = torch.randn((f, 2, 4, 8), generator=g, device="cuda")
        idx = host(torch.randperm(f, generator=g, device="cuda")[:n])
        out = ops.page_gather(s, idx, impl="kernel")
        back = ops.page_scatter(torch.zeros_like(s), idx, out, impl="kernel")
        torch.cuda.synchronize()
        il = idx.cuda().long()
        want = torch.zeros_like(s).index_copy_(0, il, s.index_select(0, il))
        checks += 1
        if not (torch.equal(out, s.index_select(0, il)) and torch.equal(back, want)):
            fails.append(f"page_gather/page_scatter round trip n={n} f={f}")
    return checks


def median_pairs(hist) -> int:
    """The median of a histogram of pairs per flush (the lower middle)."""
    pairs = sorted(hist.elements())
    return pairs[(len(pairs) - 1) // 2]


def time_page_migrate(torch, gen, F, frame, pairs, flush):
    """Times of one gather and one scatter at ``pairs`` live pairs over a
    (K, V) pair of ``(F,) + frame`` stores (the flush's shape), and at 64
    live frames of one store: kernel, plain version, library calls
    (``index_select`` / ``index_copy_`` once per store), and the bytes
    bound, each live byte read once and written once."""
    from repro_torch.kernels import page_migrate as pm

    stores = tuple(torch.randn((F,) + tuple(frame), generator=gen, device="cuda")
                   for _ in range(2))
    fb = stores[0][0].numel() * stores[0].element_size()
    out = {}
    for key, S, n in (("flush", 2, pairs), ("one_store_64_live", 1, 64)):
        src = torch.randperm(F - 1, generator=gen, device="cuda")[:n].to(torch.int32)
        dst = torch.randperm(F - 1, generator=gen, device="cuda")[:n].to(torch.int32)
        src_h, dst_h = src.cpu(), dst.cpu()
        src_l, dst_l = src.long(), dst.long()
        arg = stores[0] if S == 1 else stores
        staged = pm.page_gather(arg, src_h)
        work = tuple(s.clone() for s in stores[:S])
        warg = work[0] if S == 1 else work
        pages = staged if S > 1 else staged[None]
        nbytes = 2 * S * n * fb
        b_ms, b_by = bound(nbytes, 0.0)
        shape = (f"{n} pairs x {S} store{'s' if S > 1 else ''} of (L, Hkv, P, D) = "
                 f"{tuple(frame)} f32, {fb} B a frame, store F={F}")
        out[key] = {
            "page_gather": dict(
                shape=shape,
                kernel_ms=time_ms(torch, lambda: pm.page_gather(arg, src_h), flush),
                # the plain version given the frames on the card: its device work
                plain_ms=time_ms(torch, lambda: pm.page_gather_plain(arg, src), flush),
                library_ms=time_ms(torch, lambda: [s.index_select(0, src_l)
                                                   for s in stores[:S]], flush),
                library_call=" + ".join(["index_select"] * S),
                bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes),
            "page_scatter": dict(
                shape=shape,
                kernel_ms=time_ms(torch, lambda: pm.page_scatter(warg, dst_h, staged),
                                  flush),
                plain_ms=time_ms(torch, lambda: pm.page_scatter_plain(warg, dst, staged),
                                 flush),
                library_ms=time_ms(torch, lambda: [w.index_copy_(0, dst_l, p)
                                                   for w, p in zip(work, pages)], flush),
                library_call=" + ".join(["index_copy_"] * S),
                bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes),
        }
        if key == "flush":  # the flush as it runs: gather, then scatter
            out[key]["gather_then_scatter_ms"] = time_ms(
                torch, lambda: pm.page_scatter(warg, dst_h, pm.page_gather(arg, src_h)),
                flush)
    return out


def check_moe_fwd(torch, cfg, fails):
    """One MoE layer at ``cfg``'s widths on the card against the same call
    on the CPU, on the same weights: phi3.5-moe's decode batch (8 lanes,
    3 of them identical pad lanes) and prefill (47 tokens).  At capacity
    factor 1.25 experts overflow, so this holds the dropping of
    assignments (the overflow slot, ``index_add_``) on the card; ``y``
    within ``TOL["float32"]``, the aux loss within 1e-6."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe, nn
    from repro_torch.models.model import tree_map

    mcfg = cfg.all_specs()[0].moe
    d, E, K = cfg.d_model, mcfg.n_experts, mcfg.top_k
    gen = torch.Generator(device="cuda").manual_seed(5)
    p = moe.init_moe(gen, d, mcfg, device="cuda")
    p_cpu = tree_map(lambda t: t.cpu(), p)
    decode = torch.randn((8, 1, d), generator=gen, device="cuda")
    decode[5:] = decode[5]  # pad lanes, as the engine's padded decode batch
    cases = {"decode T=8 (3 pad lanes)": decode,
             "prefill T=47": torch.randn((1, 47, d), generator=gen, device="cuda")}
    out = {"widths": f"d={d}, E={E}, top-{K}, d_ff_expert={mcfg.d_ff_expert}, "
                     f"capacity_factor={mcfg.capacity_factor}"}
    for name, x in cases.items():
        y, aux = moe.moe_fwd(p, mcfg, x)
        torch.cuda.synchronize()
        y_cpu, aux_cpu = moe.moe_fwd(p_cpu, mcfg, x.cpu())
        T = x.shape[0] * x.shape[1]
        C = max(1, int(mcfg.capacity_factor * T * K / E))
        idx = ops.router_topk(nn.dense(p_cpu["router"], x.cpu().reshape(T, d)), K)[2]
        counts = torch.bincount(idx.reshape(-1).long(), minlength=E)
        dropped = int((counts - C).clamp_min(0).sum())
        err = (y.cpu() - y_cpu).abs().max().item()
        aux_err = abs(float(aux) - float(aux_cpu))
        ok = (bool(torch.isfinite(y).all()) and aux_err <= 1e-6 and torch.allclose(
            y.cpu(), y_cpu, atol=TOL["float32"], rtol=TOL["float32"]))
        out[name] = {"capacity": C, "dropped": dropped, "max_abs_err": err,
                     "aux_abs_err": aux_err, "ok": ok}
        if not ok:
            fails.append(f"moe_fwd {name} cuda != cpu: y max_abs_err {err}, "
                         f"aux err {aux_err}")
        if dropped <= 0:
            fails.append(f"moe_fwd {name}: no expert overflowed its capacity {C}, "
                         f"so dropping went unchecked")
    log(f"[kernels] moe_fwd cuda vs cpu {json.dumps(out)}")
    del p, p_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_empty_inputs(torch, fails):
    """A wrapper given nothing to do returns without launching, so it
    must not count a launch."""
    from repro_torch.kernels import ops

    dev = "cuda"
    ops.reset_launch_counts()
    ops.flash_attention(torch.empty((1, 4, 0, 64), device=dev),
                        torch.empty((1, 2, 0, 64), device=dev),
                        torch.empty((1, 2, 0, 64), device=dev), impl="kernel")
    ops.router_topk(torch.empty((0, 16), device=dev), 2, impl="kernel")
    ops.moe_route(torch.empty((0, 64), device=dev), torch.empty((64, 16), device=dev), 2, 1,
                  impl="kernel")
    ops.moe_dispatch(torch.empty((4, 0), device=dev),
                     torch.full((16,), -1, dtype=torch.int32, device=dev), 16, 1,
                     impl="kernel")
    ops.moe_combine(torch.empty((16, 1, 64), device=dev),
                    torch.empty((0,), dtype=torch.int32, device=dev),
                    torch.empty((0, 2), device=dev), impl="kernel")
    ops.moe_combine_bwd(torch.empty((0, 64), device=dev), torch.empty((16, 1, 64), device=dev),
                        torch.empty((0,), dtype=torch.int32, device=dev),
                        torch.empty((0, 2), device=dev), impl="kernel")
    ops.paged_attention(torch.empty((0, 4, 64), device=dev),
                        torch.empty((3, 2, 16, 64), device=dev),
                        torch.empty((3, 2, 16, 64), device=dev),
                        torch.empty((0, 2), dtype=torch.int32, device=dev),
                        torch.empty((0,), dtype=torch.int32, device=dev), impl="kernel")
    store = torch.zeros((3, 2, 16, 64), device=dev)
    none = torch.empty((0,), dtype=torch.int32)  # frames live on the host
    for arg in (store, (store, store.clone())):
        pages = ops.page_gather(arg, none, impl="kernel")
        ops.page_scatter(arg, none, pages, impl="kernel")
    torch.cuda.synchronize()
    counted = {k: n for k, n in ops.launch_counts().items() if n}
    if counted:
        fails.append(f"empty inputs counted launches: {counted}")


def check_router_topk(torch, gen, flush, fails):
    """Kernel against plain version: indices equal, probs and vals within
    1e-6 (``tests/test_kernels.py:148-150``)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import router_topk as rt

    tol = 1e-6
    errs = []

    def run(name, x, k, want_idx=None):
        got = ops.router_topk(x, k, impl="kernel")
        torch.cuda.synchronize()
        want = ops.router_topk(x, k, impl="ref")
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got[:2], want[:2]))
        errs.append(err)
        ok = (all(bool(torch.isfinite(g).all()) for g in got[:2])
              and torch.equal(got[2], want[2]) and err <= tol)
        if want_idx is not None:
            ok &= got[2].tolist() == want_idx
        if not ok:
            fails.append(f"router_topk {name}: max_abs_err {err}, indices equal "
                         f"{torch.equal(got[2], want[2])}")

    inputs = {}
    for name, T, E, k in (("decode", 8, 16, 2), ("prefill", 47, 16, 2),
                          ("sweep", 64, 16, 2), ("sweep", 100, 64, 6),
                          ("sweep", 7, 8, 2), ("kernel_bench", 4096, 64, 6)):
        x = torch.randn((T, E), generator=gen, device="cuda")
        inputs[(T, E, k)] = x
        run(f"{name} T={T} E={E} k={k}", x, k)
    ties = torch.zeros((4, 16), device="cuda")
    ties[1, [3, 9, 12]] = 2.0
    ties[2, [15, 0]] = 1.0
    ties[3] = torch.arange(16, device="cuda") % 4
    run("exact ties", ties, 3, [[0, 1, 2], [3, 9, 12], [0, 15, 1], [3, 7, 11]])

    def timed(T, E, k):
        x = inputs[(T, E, k)]
        # bytes: logits read, probs written, vals and idx written; operations:
        # max, subtract, exp, sum and divide per logit, then k rounds of a
        # compare and a select per logit
        nbytes = 8 * T * E + 8 * T * k
        b_ms, b_by = bound(nbytes, T * E * (5 + 2 * k))
        return dict(kernel_ms=time_ms(torch, lambda: rt.router_topk(x, k), flush),
                    plain_ms=time_ms(torch, lambda: rt.router_topk_plain(x, k), flush),
                    bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes)

    return {
        "name": "router_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/router_topk.cu",
        "replaces": "src/repro/kernels/router_topk.py:60",
        "shape": "logits (8, 16) f32, k=2 (phi3.5-moe decode at batch 8)",
        "max_abs_err": max(errs), "tolerance": tol, "indices": "equal",
        **timed(8, 16, 2),
        "library_ms": None,
        "prefill_T47": timed(47, 16, 2),
        "kernel_bench_T4096_E64_k6": timed(4096, 64, 6),
        "checks": len(errs),
    }


def tie_experts(E):
    """The three experts that tie for the top in the route's tie case."""
    return [1, E // 2, E - 1]


def route_cases(torch, gen, d, E, k, factor):
    """``(name, x, w, k, C)`` of the fused route's checks: the router of
    ``(d, E, k)`` at its serve shapes (decode with 3 identical pad lanes,
    prefill), drop-free, exact ties, token counts that leave a ragged
    tile, and deepseek-v2-lite's router; C by the engine's formula."""
    def rand(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    def cap(T, kk, EE, f=factor):
        return max(1, int(f * T * kk / EE))

    w = rand(d, E, std=0.02)  # nn.dense_init(std=0.02), as init_moe
    decode = rand(8, d)
    decode[5:] = decode[5]
    # zero rows tie every expert; a row whose one nonzero entry is x[t, 0]
    # > 0 has logits x[t, 0] * w[0], exact, and three equal entries of
    # w[0] tie for the top
    ties = torch.zeros((8, d), device="cuda")
    ties[3:, 0] = rand(5).abs() + 0.1
    w_ties = w.clone()
    w_ties[0, tie_experts(E)] = 1.0
    prefill = rand(47, d)
    cases = [
        (f"decode T=8 d={d} E={E} k={k} (3 pad lanes)", decode, w, k, cap(8, k, E)),
        (f"prefill T=47", prefill, w, k, cap(47, k, E)),
        ("prefill T=47 drop-free (capacity factor 8.0)", prefill, w, k, cap(47, k, E, 8.0)),
        ("exact ties T=8 k=3", ties, w_ties, 3, cap(8, 3, E)),
        ("T=100 (a ragged last tile of 8-row tiles)", rand(100, d), w, k, cap(100, k, E)),
        ("T=1500 (a ragged last tile of 64-row tiles)", rand(1500, d), w, k, cap(1500, k, E)),
        # deepseek-v2-lite's router (repro/configs/deepseek_v2_lite_16b.py:52)
        ("deepseek-v2-lite T=4096 d=2048 E=64 k=6", rand(4096, 2048), rand(2048, 64, std=0.02),
         6, cap(4096, 6, 64)),
    ]
    return cases


def check_moe_route(torch, gen, cfg, flush, fails):
    """The fused route, dispatch and combine on the card against their
    plain versions.  ``idx``, ``slot``, ``src`` and ``counts`` exactly
    equal to the plain routing run on the kernel's own logits (a near-tie
    after another product order must not decide the check), ``probs``,
    ``vals`` and ``aux`` within 1e-6 of it, ``logits`` within
    ``TOL["float32"]`` of ``torch.mm``, two runs on the same scratch bit
    for bit, the counters back at zero; dispatch and combine exactly
    equal to their plain versions.  Returns the three kernels' rows."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import router_topk as rt

    mcfg = cfg.all_specs()[0].moe
    d, E, K = cfg.d_model, mcfg.n_experts, mcfg.top_k
    cases = route_cases(torch, gen, d, E, K, mcfg.capacity_factor)
    tol = 1e-6
    errs, lerrs, out = [], [], {}
    for name, x, w, k, C in cases:
        got = ops.moe_route(x, w, k, C, impl="kernel")
        again = ops.moe_route(x, w, k, C, impl="kernel")
        torch.cuda.synchronize()
        want = rt.route_logits_plain(got.logits, k, C)
        mm = torch.mm(x, w)
        torch.cuda.synchronize()
        lerr = (got.logits - mm).abs().max().item()
        err = max((got.probs - want.probs).abs().max().item(),
                  (got.vals - want.vals).abs().max().item())
        aux_err = abs(float(got.aux) - float(want.aux))
        exact = {f: torch.equal(getattr(got, f), getattr(want, f).to(torch.int32))
                 for f in ("idx", "slot", "src", "counts")}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        dropped = int((got.counts - C).clamp_min(0).sum())
        ok = (all(exact.values()) and same and err <= tol and aux_err <= tol
              and bool(torch.isfinite(got.logits).all()) and torch.allclose(
                  got.logits, mm, atol=TOL["float32"], rtol=TOL["float32"]))
        if name.startswith("exact ties"):
            ok &= got.idx.tolist() == [[0, 1, 2]] * 3 + [tie_experts(w.shape[1])] * 5
        errs.append(err)
        lerrs.append(lerr)
        # dispatch and combine at this case's routing
        Ek = w.shape[1]
        xe = ops.moe_dispatch(x, got.src, Ek, C, impl="kernel")
        ye = torch.randn((Ek, C, x.shape[1]), generator=gen, device="cuda")
        y = ops.moe_combine(ye, got.slot, got.vals, impl="kernel")
        torch.cuda.synchronize()
        glue = {"dispatch": torch.equal(xe, ops.moe_dispatch(x, got.src, Ek, C, impl="ref")),
                "combine": torch.equal(y, ops.moe_combine(ye, got.slot, got.vals,
                                                          impl="ref"))}
        out[name] = dict(capacity=C, dropped=dropped, logits_max_abs_err=lerr,
                         max_abs_err=err, aux_abs_err=aux_err, equal=exact,
                         rerun_bit_identical=same, **glue)
        if not ok:
            fails.append(f"moe_route {name}: {out[name]}")
        if not all(glue.values()):
            fails.append(f"moe_dispatch/moe_combine {name}: {glue}")
        del xe, ye, y
    try:  # refused before it runs: the counters stay as they are
        ops.moe_route(cases[0][1], cases[0][2], 9, 1, impl="kernel")
        fails.append("moe_route took k=9")
    except ValueError:
        pass
    torch.cuda.synchronize()
    left = sum(int(b.abs().sum()) for b in build._counters.values())
    if left:
        fails.append(f"moe_route left its counters at {left}, not 0")
    log(f"[kernels] moe_route checks {json.dumps(out)}")

    by = {n: (x, w, k, C) for n, x, w, k, C in cases}
    timed_cases = {"decode": cases[0][0], "prefill": cases[1][0],
                   "deepseek_v2_lite": cases[-1][0]}

    def route_times(x, w, k, C):
        T, dd = x.shape
        Ek = w.shape[1]
        nbytes = 4 * (T * dd + dd * Ek + 2 * T * Ek + 3 * T * k + Ek * C + Ek + 1)
        b_ms, b_by = bound(nbytes, 2.0 * T * dd * Ek)
        return dict(
            kernel_ms=time_ms(torch, lambda: rt.moe_route(x, w, k, C), flush),
            plain_ms=time_ms(torch, lambda: rt.moe_route_plain(x, w, k, C), flush),
            # the unfused chain: the product, the router_topk kernel, and the
            # torch lines of the slots, src and aux
            unfused_chain_ms=time_ms(torch, lambda: rt.route_logits_plain(
                torch.mm(x, w), k, C, topk=rt.router_topk), flush),
            library_ms=time_ms(torch, lambda: torch.mm(x, w), flush),
            library_call="torch.mm (the router product alone)",
            bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes, bound_flops=2.0 * T * dd * Ek)

    def glue_times(x, w, k, C):
        T, dd = x.shape
        Ek = w.shape[1]
        r = rt.moe_route(x, w, k, C)
        ye = torch.randn((Ek, C, dd), generator=gen, device="cuda")
        src, slot, vals = r.src, r.slot, r.vals
        slot_l = slot.long()
        kept = int((src >= 0).sum())
        rows = int(torch.unique(src[src >= 0]).numel())

        def dispatch_lines():  # the torch lines moe_dispatch replaces
            xe = torch.zeros((Ek * C + 1, dd), device="cuda")
            xe.index_add_(0, slot_l, x.repeat_interleave(k, dim=0))
            return xe[:Ek * C].reshape(Ek, C, dd)

        def combine_lines():  # the torch lines moe_combine replaces
            ye_flat = torch.cat([ye.reshape(Ek * C, dd), ye.new_zeros((1, dd))], dim=0)
            yk = ye_flat[slot_l].reshape(T, k, dd)
            return torch.sum(yk * vals[..., None], dim=1)

        d_bytes = 4 * (rows * dd + Ek * C + Ek * C * dd)
        c_bytes = 4 * (kept * dd + 2 * T * k + T * dd)
        db_ms, db_by = bound(d_bytes, 0.0)
        cb_ms, cb_by = bound(c_bytes, 2.0 * T * k * dd)
        return {
            "moe_dispatch": dict(
                kernel_ms=time_ms(torch, lambda: md.moe_dispatch(x, src, Ek, C), flush),
                plain_ms=time_ms(torch, lambda: md.moe_dispatch_plain(x, src, Ek, C), flush),
                replaced_lines_ms=time_ms(torch, dispatch_lines, flush),
                library_ms=None, bound_ms=db_ms, bound_by=db_by, bound_bytes=d_bytes),
            "moe_combine": dict(
                kernel_ms=time_ms(torch, lambda: md.moe_combine(ye, slot, vals), flush),
                plain_ms=time_ms(torch, lambda: md.moe_combine_plain(ye, slot, vals), flush),
                replaced_lines_ms=time_ms(torch, combine_lines, flush),
                library_ms=None, bound_ms=cb_ms, bound_by=cb_by, bound_bytes=c_bytes,
                bound_flops=2.0 * T * k * dd),
        }

    route_t = {key: route_times(*by[n]) for key, n in timed_cases.items()}
    # the decode route with L2 warm (no flush): the launch's serial tail
    # runs in one block, and a cold L2 holds neither its data nor its code
    x, w, k, C = by[timed_cases["decode"]]
    route_t["decode"]["warm_l2_ms"] = time_ms(
        torch, lambda: rt.moe_route(x, w, k, C), torch.ones(1, device="cuda"))
    glue_t = {key: glue_times(*by[n]) for key, n in timed_cases.items()}
    rows = [{
        "name": "moe_route", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/router_topk.cu",
        "replaces": "src/repro/kernels/router_topk.py:60",
        "replaces_also": "src/repro/models/moe.py:90-119 (XLA: router product, "
                         "aux, capacity slots)",
        "shape": f"x (8, {d}) f32 @ w ({d}, {E}), k={K}, C=1, 3 pad lanes "
                 "(phi3.5-moe decode at batch 8)",
        "max_abs_err": max(errs), "tolerance": tol,
        "logits_max_abs_err": max(lerrs), "logits_tolerance": TOL["float32"],
        "indices_slots_src_counts": "equal",
        **route_t["decode"],
        "prefill_T47": route_t["prefill"],
        "deepseek_v2_lite_T4096_d2048_E64_k6": route_t["deepseek_v2_lite"],
        "checks": len(cases),
    }]
    for kname in ("moe_dispatch", "moe_combine"):
        rows.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_dispatch.cu",
            "replaces": "src/repro/models/moe.py:121",
            "replaces_note": "no TPU kernel: XLA at src/repro/models/moe.py:121-137",
            "shape": f"phi3.5-moe decode: T=8, d={d}, E={E}, k={K}, C=1",
            "max_abs_err": 0.0, "tolerance": 0.0, "exact_checks": len(cases),
            **glue_t["decode"][kname],
            "prefill_T47": glue_t["prefill"][kname],
            "deepseek_v2_lite_T4096_d2048_E64_k6": glue_t["deepseek_v2_lite"][kname],
        })
    del cases, by
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def flash_work(torch, q, k, causal, window):
    """Bytes (q, k, v read once, out written once) and FLOPs (2·D for
    q·k and 2·D for p·v per unmasked query-key pair) of one call."""
    B, H, S, D = q.shape
    T = k.shape[2]
    qp = torch.arange(S)[:, None]
    kp = torch.arange(T)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return nbytes, 4.0 * D * B * H * int(mask.sum())


def check_flash_attention(torch, gen, flush, fails, families, windowed):
    """Kernel against plain version within ``TOL``; the serve shapes go
    through the engine's (1, S, H, D) → (1, H, S, D) transposed views.
    The traffic phase's prefills, tinyllama's heads at each prompt length
    of ``DEFAULT_MIX``, are checked each and timed at three.
    ``families``: name → config of each family served in phase 3, checked
    and timed at its prefill (S=47, its first layer's window);
    ``windowed``: ``(name, cfg, S)`` of the windowed run's prefill, with
    and without the window."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.traffic import DEFAULT_MIX

    checks = []

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def run(name, q, k, v, causal, window, dtype_name):
        got = ops.flash_attention(q, k, v, causal=causal, window=window, impl="kernel")
        torch.cuda.synchronize()
        want = ops.flash_attention(q, k, v, causal=causal, window=window, impl="ref")
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got.float(), want.float(), atol=TOL[dtype_name], rtol=TOL[dtype_name])
        checks.append({"case": name, "dtype": dtype_name, "max_abs_err": err, "ok": ok})
        if not ok:
            fails.append(f"flash_attention {name} {dtype_name}: max_abs_err {err}")

    timed_cases = {}
    for name, H, Hkv, S, D in (("phi3.5-moe prefill", 32, 8, 47, 128),
                               ("tinyllama-1.1b prefill", 32, 4, 47, 64)):
        q = rand(1, S, H, D).transpose(1, 2)
        k = rand(1, S, Hkv, D).transpose(1, 2)
        v = rand(1, S, Hkv, D).transpose(1, 2)
        run(f"{name} H={H} Hkv={Hkv} S={S} D={D} (views)", q, k, v, True, None,
            "float32")
        timed_cases[name] = (q, k, v)
    # the traffic runs' prefills (and restarts after an eviction): tinyllama's
    # heads at every prompt length DEFAULT_MIX draws
    lo = min(m.prompt_len[0] for m in DEFAULT_MIX)
    hi = max(m.prompt_len[1] for m in DEFAULT_MIX)
    for S in range(lo, hi + 1):
        qkv = (rand(1, S, 32, 64).transpose(1, 2), rand(1, S, 4, 64).transpose(1, 2),
               rand(1, S, 4, 64).transpose(1, 2))
        run(f"tinyllama-1.1b traffic prefill H=32 Hkv=4 S={S} D=64 (views)", *qkv, True,
            None, "float32")
        if S in (lo, (lo + hi) // 2, hi):
            timed_cases[f"tinyllama-1.1b traffic prefill S={S}"] = qkv
    # the sweeps of tests/test_kernels.py:26-37
    for (B, H, Hkv, S, D, causal, window) in [
            (1, 4, 4, 128, 64, True, None), (2, 8, 2, 96, 32, True, None),
            (1, 4, 2, 200, 64, True, 64), (1, 2, 1, 64, 128, True, None),
            (2, 2, 2, 40, 16, False, None), (1, 8, 4, 256, 256, True, 128)]:
        for dtype_name, dtype in (("float32", torch.float32),
                                  ("bfloat16", torch.bfloat16)):
            run(f"sweep B={B} H={H} Hkv={Hkv} S={S} D={D} causal={causal} "
                f"window={window}", rand(B, H, S, D, dtype=dtype),
                rand(B, Hkv, S, D, dtype=dtype), rand(B, Hkv, S, D, dtype=dtype),
                causal, window, dtype_name)
    # benchmarks/kernel_bench.py:33-36
    kb = (rand(1, 8, 512, 64), rand(1, 2, 512, 64), rand(1, 2, 512, 64))
    run("kernel_bench B=1 H=8 Hkv=2 S=512 D=64", *kb, True, None, "float32")
    timed_cases["kernel_bench"] = kb
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        # a ragged prompt: the last query tile and key tile hold one row
        run("ragged B=1 H=8 Hkv=2 S=513 D=64", rand(1, 8, 513, 64, dtype=dtype),
            rand(1, 2, 513, 64, dtype=dtype), rand(1, 2, 513, 64, dtype=dtype),
            True, None, dtype_name)
        # a width off the templates (zero-padded to 128), a window
        run("padded B=2 H=4 Hkv=2 S=100 D=80 window=33",
            rand(2, 4, 100, 80, dtype=dtype), rand(2, 2, 100, 80, dtype=dtype),
            rand(2, 2, 100, 80, dtype=dtype), True, 33, dtype_name)
    # phi3.5-moe's heads at a long prompt
    long = (rand(1, 32, 2048, 128), rand(1, 8, 2048, 128), rand(1, 8, 2048, 128))
    run("phi3.5-moe heads B=1 H=32 Hkv=8 S=2048 D=128", *long, True, None, "float32")
    kb16 = tuple(t.to(torch.bfloat16) for t in kb)
    run("kernel_bench bf16", *kb16, True, None, "bfloat16")
    d96 = (rand(1, 8, 512, 96), rand(1, 2, 512, 96), rand(1, 2, 512, 96))
    run("padded B=1 H=8 Hkv=2 S=512 D=96", *d96, True, None, "float32")
    # rows 4 bytes off 16-byte alignment: the general, element-by-element loader
    odd = tuple(torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape) for t in kb)
    run("unaligned rows B=1 H=8 Hkv=2 S=512 D=64", *odd, True, None, "float32")

    # each family's prefill of a 48-token prompt, windowed as its first layer
    fam_cases = {}
    for fname, fcfg in families.items():
        a = fcfg.all_specs()[0].attn
        H, Hkv, D = a.n_heads, a.n_kv_heads, a.head_dim
        qkv = (rand(1, 47, H, D).transpose(1, 2), rand(1, 47, Hkv, D).transpose(1, 2),
               rand(1, 47, Hkv, D).transpose(1, 2))
        run(f"{fname} prefill H={H} Hkv={Hkv} S=47 D={D} window={a.window} (views)",
            *qkv, True, a.window, "float32")
        fam_cases[fname] = (qkv, a.window)
    # the windowed run's prompt, longer than the window: local and global layers
    wname, wcfg, wS = windowed
    a = wcfg.all_specs()[0].attn
    wqkv = (rand(1, wS, a.n_heads, a.head_dim).transpose(1, 2),
            rand(1, wS, a.n_kv_heads, a.head_dim).transpose(1, 2),
            rand(1, wS, a.n_kv_heads, a.head_dim).transpose(1, 2))
    for window in (a.window, None):
        run(f"{wname} windowed run prefill H={a.n_heads} Hkv={a.n_kv_heads} S={wS} "
            f"D={a.head_dim} window={window} (views)", *wqkv, True, window, "float32")
        fam_cases[f"{wname} windowed run S={wS} window={window}"] = (wqkv, window)

    def timed(q, k, v, iters=50, window=None):
        nbytes, flops = flash_work(torch, q, k, True, window)
        b_ms, b_by = bound(nbytes, flops, str(q.dtype).removeprefix("torch."))
        sdpa = dict(is_causal=True)
        if window is not None:  # SDPA takes a window as an explicit mask
            qp = torch.arange(q.shape[2], device=q.device)[:, None]
            kp = torch.arange(k.shape[2], device=q.device)[None, :]
            sdpa = dict(attn_mask=(kp <= qp) & (kp > qp - window))
        lib = F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **sdpa)
        want = fa.flash_attention_plain(q, k, v, window=window)
        return dict(
            kernel_ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, window=window),
                              flush, iters),
            plain_ms=time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, window=window), flush, iters),
            bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes, bound_flops=flops,
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True, **sdpa), flush, iters),
            library_max_abs_err=(lib.float() - want.float()).abs().max().item())

    f32 = [c for c in checks if c["dtype"] == "float32"]
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:123",
        "shape": "q (1, 32, 47, 128), k/v (1, 8, 47, 128) f32, causal, "
                 "transposed views (phi3.5-moe prefill)",
        "max_abs_err": max(c["max_abs_err"] for c in f32),
        "tolerance": TOL["float32"],
        "max_abs_err_bf16": max(c["max_abs_err"] for c in checks
                                if c["dtype"] == "bfloat16"),
        "tolerance_bf16": TOL["bfloat16"],
        **timed(*timed_cases["phi3.5-moe prefill"]),
        "tinyllama_prefill_D64_Hkv4": timed(*timed_cases["tinyllama-1.1b prefill"]),
        "tinyllama_traffic_prefills": {
            f"S={q.shape[2]}": timed(q, k, v) for name, (q, k, v) in timed_cases.items()
            if name.startswith("tinyllama-1.1b traffic")},
        "kernel_bench_S512_D64_Hkv2": timed(*kb),
        "phi3_5_heads_S2048_D128_Hkv8": timed(*long, iters=10),
        "bf16_S512_D64_Hkv2": timed(*kb16),
        "padded_S512_D96_Hkv2": timed(*d96),
        "general_path_unaligned_S512_D64_Hkv2": timed(*odd),
        "families": {name: dict(timed(*qkv, window=window), shape=(
            f"q {tuple(qkv[0].shape)}, k/v {tuple(qkv[1].shape)} f32, causal, "
            f"window={window}, transposed views"))
            for name, (qkv, window) in fam_cases.items()},
        "checks": len(checks),
    }


# --------------------------------------------------------------------- #
def main() -> None:
    # cuBLAS is deterministic with this workspace (read when cuBLAS starts);
    # the [train] phase's relaunch is held to its first run bit for bit
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs an NVIDIA card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.benchmarks.traffic_bench import ENGINE_CONFIG as TRAFFIC_ECFG
    from repro_torch.configs import get_config
    from repro_torch.core import TppConfig
    from repro_torch.kernels import build
    from repro_torch.launch.serve import pages_needed, strict_fp32
    from repro_torch.models.model import init_params, param_bytes
    from repro_torch.serving import EngineConfig
    from repro_torch.serving.kv_cache import bucket

    t_start = time.perf_counter()
    # ---------------- phase 1: device --------------------------------- #
    smi = gpu_line()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device_count {torch.cuda.device_count()}")
    strict_fp32()
    log(f"[device] TF32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32} (float32 throughout)")
    t0 = time.perf_counter()
    logs = build.build()
    log(f"[build] {sorted(logs) or 'cached'} in {time.perf_counter() - t0:.1f} s "
        f"into {build.BUILD_DIR.relative_to(ROOT)}/")
    for name, text in logs.items():
        for fn, regs, spills in ptxas_usage(text):
            log(f"[build] {name}: {fn}: {regs}; {spills}")

    # the serving configuration of phase 3 (and the kernel shapes it gives)
    cfg = get_config("tinyllama-1.1b")
    moe_full = get_config(MOE_ARCH)
    moe_cfg = dataclasses.replace(moe_full, stacks=((moe_full.stacks[0][0], MOE_LAYERS),))
    ecfg = EngineConfig(page_size=16, num_fast=24, num_slow=64, topk_pages=4,
                        max_seqs=8, tpp=TppConfig(demote_budget=64, promote_budget=32))
    F = ecfg.num_fast + ecfg.num_slow + 1
    fam_cfgs = {name: get_config(name) for name in FAMILIES}
    win_cfg = fam_cfgs[WINDOWED_ARCH]
    # 2 × 70 pages in 48 fast frames: the run tiers
    win_ecfg = dataclasses.replace(ecfg, topk_pages=None, num_fast=48, num_slow=128)
    win_pages = pages_needed(1, WINDOWED["prompt_len"], WINDOWED["max_new"],
                             ecfg.page_size)
    windowed_attn = (WINDOWED_ARCH, win_cfg, win_ecfg.num_fast + win_ecfg.num_slow + 1,
                     bucket(win_pages), win_pages)

    # ---------------- phase 2: kernels -------------------------------- #
    fails: list = []
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flush = torch.ones(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
    rows = [check_paged_attention(torch, gen, F, cfg.n_layers, MOE_LAYERS, flush, fails,
                                  fam_cfgs, windowed_attn)]
    # the copy kernels at each serve path's frame; timed in phase 6, at
    # the flush sizes the serve runs give them
    moe_frame = frame_shape(moe_cfg, ecfg)
    frames = {"tinyllama-1.1b": frame_shape(cfg, ecfg), MOE_ARCH: moe_frame}
    frames.update({name: frame_shape(c, ecfg) for name, c in fam_cfgs.items()})
    copy_checks = check_page_migrate(torch, gen, F, frames["tinyllama-1.1b"], fails)
    for name in list(frames)[1:]:
        copy_checks += check_page_migrate(torch, gen, F, frames[name], fails, sweeps=False)
    # the traffic phase's shapes: P=4 pages, 273 frames, its (22, 4, 4, 64) frame
    traffic_F = TRAFFIC_ECFG.num_fast + TRAFFIC_ECFG.num_slow + 1
    traffic_frame = frame_shape(cfg, TRAFFIC_ECFG)
    copy_checks += check_page_migrate(torch, gen, traffic_F, traffic_frame, fails,
                                      sweeps=False)
    traffic_attn = check_traffic_attention(torch, gen, traffic_F, cfg,
                                           TRAFFIC_ECFG.page_size, flush, fails)
    rows[0]["traffic_P4"] = traffic_attn
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"], traffic_attn["max_abs_err"])
    rows[0]["max_abs_err_bf16"] = max(rows[0]["max_abs_err_bf16"],
                                      traffic_attn["max_abs_err_bf16"])
    log(f"[kernels] page_gather/page_scatter: {copy_checks} exact checks")
    rows.append(check_router_topk(torch, gen, flush, fails))
    rows += check_moe_route(torch, gen, moe_cfg, flush, fails)
    rows[-3]["moe_fwd_cuda_vs_cpu"] = check_moe_fwd(torch, moe_cfg, fails)
    check_empty_inputs(torch, fails)
    rows.append(check_flash_attention(torch, gen, flush, fails, fam_cfgs,
                                      (WINDOWED_ARCH, win_cfg, WINDOWED["prompt_len"] - 1)))
    del flush
    if fails:
        fail("; ".join(fails))

    # ---------------- phase 3: serve ---------------------------------- #
    launches_by_path, flush_pairs = {}, {}
    for name, c in (("tinyllama-1.1b", cfg), (MOE_ARCH, moe_cfg), *fam_cfgs.items()):
        if c is moe_cfg:
            log(f"[serve] {MOE_ARCH}: depth cut from {moe_full.n_layers} to "
                f"{moe_cfg.n_layers} layers ({param_bytes(moe_cfg) / 1e9:.1f} GB of "
                f"float32 weights; all {moe_full.n_layers} would be "
                f"{param_bytes(moe_full) / 1e9:.1f} GB), widths as published")
        launches_by_path[name], flush_pairs[name] = serve_phase(torch, name, c, ecfg)

    # the paper's comparison systems and the reference plane, at full width
    tparams = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
    for policy in BASELINES:
        launches_by_path[f"tinyllama-1.1b/{policy}"] = policy_phase(
            torch, cfg, ecfg, tparams, policy)
    launches_by_path.update(reference_phase(torch, cfg, ecfg, tparams))
    del tparams
    gc.collect()
    torch.cuda.empty_cache()
    # the first serve run whose window masks: both planes of gemma3-4b on
    # prompts longer than its local window
    wparams = init_params(win_cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
    launches_by_path.update(reference_phase(
        torch, win_cfg, win_ecfg, wparams, name=WINDOWED_ARCH,
        placement=WINDOWED_PLACEMENT, **WINDOWED))
    del wparams
    gc.collect()
    torch.cuda.empty_cache()

    # smoke configs: each lifecycle on cuda and on cpu must agree exactly,
    # every interval audited and every flush's plan checked
    os.environ["TIERSAN_LEVEL"] = "full"
    os.environ["TIERSAN_PLAN_CHECK"] = "1"
    for arch in ("tinyllama-1.1b", MOE_ARCH) + FAMILIES:
        smoke_lifecycle(torch, arch)
    for arch in ("tinyllama-1.1b", MOE_ARCH) + FAMILIES:
        smoke_lifecycle(torch, arch, data_plane="reference")
    for policy in BASELINES[:3]:
        smoke_lifecycle(torch, "tinyllama-1.1b", policy=policy)
    smoke_lifecycle(torch, "tinyllama-1.1b", qos=True)
    del os.environ["TIERSAN_LEVEL"], os.environ["TIERSAN_PLAN_CHECK"]

    # ---------------- phase 4: traffic, then the fleet ----------------- #
    tparams = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    traffic_launches, flush_pairs["tinyllama-1.1b/traffic"] = traffic_phase(
        torch, cfg, tparams, smi)
    launches_by_path.update(traffic_launches)
    launches_by_path.update(fleet_phase(torch, cfg, tparams, smi))
    del tparams
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------- phase 5: the expert tier ------------------------ #
    expert_tier_phase(torch, moe_full, smi)

    # ---------------- phase 6: the copies at the serve runs' flushes --- #
    flush = torch.ones(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
    copy_times = {}
    for name in frames:
        med = median_pairs(flush_pairs[name])
        copy_times[name] = time_page_migrate(torch, gen, F, frames[name], med, flush)
        log(f"[kernels] copies at {name}'s median flush of {med} pairs: "
            f"{json.dumps(copy_times[name])}")
    med = median_pairs(flush_pairs["tinyllama-1.1b/traffic"])
    traffic_copies = time_page_migrate(torch, gen, traffic_F, traffic_frame, med, flush)
    log(f"[kernels] copies at the traffic runs' median flush of {med} pairs: "
        f"{json.dumps(traffic_copies)}")
    del flush
    for kname, line in (("page_gather", "src/repro/kernels/page_migrate.py:47"),
                        ("page_scatter", "src/repro/kernels/page_migrate.py:79")):
        main_t = copy_times["tinyllama-1.1b"]
        moe_t = copy_times[MOE_ARCH]
        rows.insert(1 if kname == "page_gather" else 2, {
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/page_migrate.cu",
            "replaces": line,
            "max_abs_err": 0.0, "tolerance": 0.0, "exact_checks": copy_checks,
            **main_t["flush"][kname],
            "flush_pairs_histogram": {
                n: {str(k): v for k, v in sorted(h.items())} for n, h in flush_pairs.items()},
            "gather_then_scatter_ms": main_t["flush"]["gather_then_scatter_ms"],
            "one_store_64_live": main_t["one_store_64_live"][kname],
            "phi3_5_moe_serve": dict(
                moe_t["flush"][kname],
                gather_then_scatter_ms=moe_t["flush"]["gather_then_scatter_ms"],
                one_store_64_live=moe_t["one_store_64_live"][kname]),
            "families": {name: dict(
                copy_times[name]["flush"][kname],
                gather_then_scatter_ms=copy_times[name]["flush"]["gather_then_scatter_ms"],
                one_store_64_live=copy_times[name]["one_store_64_live"][kname])
                for name in FAMILIES},
            "traffic_P4": dict(
                traffic_copies["flush"][kname],
                gather_then_scatter_ms=traffic_copies["flush"]["gather_then_scatter_ms"],
                one_store_64_live=traffic_copies["one_store_64_live"][kname]),
        })
    # ---------------- [train]: the training path ---------------------- #
    launches_by_path.update(train_phase(torch, moe_full, smi, rows))

    for r in rows:
        log(f"[kernels] {r['name']}: max_abs_err {r['max_abs_err']} "
            f"(tol {r['tolerance']}) kernel {r['kernel_ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']}) library {r['library_ms']}")

    for r in rows:
        r["launches_by_path"] = {p: n[r["name"]] for p, n in launches_by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        r["ms"] = r["kernel_ms"]  # the same time under the kernels line's short key
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def serve_phase(torch, name, cfg, ecfg):
    """Serve ``cfg`` at full width on the card with launch counts set to 0
    just before and read just after; check the counts, tiering, tokens
    and the pool's invariants.  Frees the weights before it returns."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import check_fits, profile_decode, serve
    from repro_torch.models.model import init_params, param_bytes

    requests, prompt_len, max_new = 8, 48, 32
    check_fits(cfg, "cuda")  # refuses, rather than cuts, a model that does not fit
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] {name} full width: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"params {sum(t.numel() for t in _leaves(params)) / 1e9:.3f} G float32, "
        f"built in {time.perf_counter() - t0:.1f} s")
    ops.reset_launch_counts()
    res = serve(cfg, params, ecfg, requests=requests, prompt_len=prompt_len,
                max_new=max_new, seed=0, device="cuda")
    launches = ops.launch_counts()
    stats = res["stats"]
    peak = torch.cuda.max_memory_allocated()
    summary = {
        "arch": name, "layers": cfg.n_layers, "steps": res["steps"],
        "n_tokens": res["n_tokens"], "ms_per_step": res["ms_per_step"],
        "tokens_per_s": res["tokens_per_s"], "prefill_s": res["prefill_s"],
        "weight_bytes": param_bytes(cfg), "peak_device_memory_bytes": peak,
        "stats": stats, "launches": launches,
    }
    log(f"[serve] {name}: {res['n_tokens']} tokens in {res['steps']} decode steps: "
        f"{res['tokens_per_s']:.2f} tok/s, {res['ms_per_step']:.3f} ms/step, "
        f"prefill of {requests} prompts {res['prefill_s']:.3f} s, peak device "
        f"memory {peak / 2**30:.2f} GiB")
    log(f"[serve] summary {json.dumps(summary)}")
    L, steps = cfg.n_layers, res["steps"]
    moe = any(s.moe is not None for s in cfg.all_specs())
    # an MoE layer routes once a forward: one launch each of the route,
    # the dispatch and the combine; the unfused router_topk is off the path
    routed = L * (steps + requests) if moe else 0
    kv = res["engine"].kv
    check_launches(name, launches, kv, L, steps, requests, routed)
    placement = {k: stats[k] for k in PLACEMENT}
    if placement != PLACEMENT:
        fail(f"{name}: placement {placement}, expected {PLACEMENT}")
    toks = [t for out in res["tokens"].values() for t in out]
    # musicgen's argmax runs over its vocab × 4 codebook table, as in JAX
    n_ids = cfg.vocab * cfg.n_codebooks
    if len(toks) != requests * max_new or not all(0 <= t < n_ids for t in toks):
        fail(f"{name}: serve phase produced malformed tokens")
    kv.pool.check_invariants()
    flush_pairs = kv.flush_pairs.copy()
    log(f"[serve] {name}: {kv.flushes} flushes, pairs per flush "
        f"{dict(sorted(flush_pairs.items()))}")
    # where a decode step's time goes: 8 traced steps of a fresh batch
    prof = profile_decode(res["engine"], cfg.vocab, requests, prompt_len, 8,
                          str(ROOT / "build" / "profile" / name))
    log(f"[serve] {name} profile {json.dumps(prof)}")
    del res, params, kv
    gc.collect()
    torch.cuda.empty_cache()
    return launches, flush_pairs


def expected_copies(kv, max_pairs):
    """Copy launches a run must count: one gather and one scatter a flush
    (a launch per ``max_pairs`` pairs) and the staged cache's one-frame
    prewarm; none on the reference plane's eager copies."""
    if not kv.cfg.staged_migration:
        return 0
    return 1 + sum(-(-n // max_pairs) * k for n, k in kv.flush_pairs.items())


def expected_launches(kv, L, decodes, prefills, routed=0):
    """A run's exact launch counts: ``paged_attention`` once a layer a
    decoding step on the batched plane (none on the reference plane),
    ``flash_attention`` once a layer a prefill (restarts after an
    eviction included), the MoE route, dispatch and combine ``routed``
    times each (the unfused ``router_topk`` is on no path), and the
    copies ``expected_copies``."""
    from repro_torch.kernels.page_migrate import MAX_PAIRS

    copies = expected_copies(kv, MAX_PAIRS)
    return {"paged_attention": L * decodes if kv.cfg.staged_migration else 0,
            "flash_attention": L * prefills, "router_topk": 0, "moe_route": routed,
            "moe_dispatch": routed, "moe_combine": routed, "moe_combine_bwd": 0,
            "page_gather": copies, "page_scatter": copies}


def check_launches(name, launches, kv, L, decodes, prefills, routed=0):
    """Fail unless ``launches`` are ``expected_launches``."""
    expected = expected_launches(kv, L, decodes, prefills, routed)
    for kname, n in expected.items():
        if launches[kname] != n:
            fail(f"{name}: {kname} launched {launches[kname]} times, expected {n} "
                 f"({decodes} decoding steps, {prefills} prefills, {kv.flushes} "
                 f"flushes + the prewarm)")


def policy_phase(torch, cfg, ecfg, params, policy):
    """Serve full-width ``cfg`` under a baseline policy on the batched
    plane with launch counts set to 0 just before and read just after;
    check the counts and the policy's semantics.  ``ideal`` gets no slow
    tier and a fast tier that holds every page of the run."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.page_migrate import MAX_PAIRS
    from repro_torch.launch.serve import ideal_num_fast, pages_needed, serve

    requests, prompt_len, max_new = 8, 48, 32
    pecfg = dataclasses.replace(ecfg, policy=policy)
    if policy == "ideal":
        pages = pages_needed(requests, prompt_len, max_new, ecfg.page_size)
        pecfg = dataclasses.replace(pecfg, num_slow=0,
                                    num_fast=ideal_num_fast(pages, ecfg.tpp))
    ops.reset_launch_counts()
    res = serve(cfg, params, pecfg, requests=requests, prompt_len=prompt_len,
                max_new=max_new, seed=0, device="cuda")
    launches = ops.launch_counts()
    name = f"tinyllama-1.1b/{policy}"
    eng, stats, steps, L = res["engine"], res["stats"], res["steps"], cfg.n_layers
    kv = eng.kv
    summary = {
        "policy": policy, "num_fast": pecfg.num_fast, "num_slow": pecfg.num_slow,
        "steps": steps, "ms_per_step": res["ms_per_step"],
        "tokens_per_s": res["tokens_per_s"], "prefill_s": res["prefill_s"],
        "local_fraction": stats["local_fraction"], "demoted": stats["demoted"],
        "promoted": stats["promoted"], "migrated_bytes": stats["migrated_bytes"],
        "flushes": kv.flushes, "launches": launches,
    }
    log(f"[policy] {name}: local_fraction {stats['local_fraction']} demoted "
        f"{stats['demoted']} promoted {stats['promoted']} migrated_bytes "
        f"{stats['migrated_bytes']} {res['ms_per_step']:.3f} ms/step")
    log(f"[policy] summary {json.dumps(summary)}")
    check_launches(name, launches, kv, L, steps, requests)
    copies = expected_copies(kv, MAX_PAIRS)
    toks = [t for out in res["tokens"].values() for t in out]
    if len(toks) != requests * max_new or not all(0 <= t < cfg.vocab for t in toks):
        fail(f"{name}: malformed tokens")
    moved = stats["demoted"] + stats["promoted"]
    broken = {
        "linux": moved != 0 or stats["migrated_bytes"] != 0 or copies != 1,
        "numa_balancing": stats["demoted"] != 0,
        "autotiering": stats["demoted"] == 0 or stats["promoted"] == 0,
        "ideal": (stats["local_fraction"] != 1.0 or stats["slow_used"] != 0
                  or moved != 0),
    }[policy]
    if broken:
        fail(f"{name}: the policy's semantics broke: {json.dumps(summary)}")
    kv.pool.check_invariants()
    del res, eng, kv
    return launches


def reference_phase(torch, cfg, ecfg, params, name="tinyllama-1.1b", requests=2,
                    prompt_len=48, max_new=8, placement=None):
    """The reference data plane at full width on the card, then the
    batched plane on the same inputs.  The reference plane launches no
    ``paged_attention`` and no copy kernel; its tokens must equal the
    batched plane's in every request but at most one, and that one must
    equal them up to a step where the reference plane's top-2 logit gap
    is below ``NEAR_TIE`` (a near-tie, which excuses that request from
    there on).  Each difference is logged with its gap.  Both planes must
    place pages alike, and as ``placement`` where one is given."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.serving import ServingEngine

    L = cfg.n_layers
    tag = f"{requests}x{max_new}" + (f"-prompt{prompt_len}" if prompt_len != 48 else "")
    recorded = []  # (step, logits row) per reference decode, in lane order
    plain_logits = ServingEngine._logits

    def recording(self, x):
        out = plain_logits(self, x)
        recorded.append((self.steps, out[0, -1].detach().clone()))
        return out

    runs, launches_by_path = {}, {}
    for plane in ("reference", "batched"):
        ops.reset_launch_counts()
        if plane == "reference":
            ServingEngine._logits = recording
        try:
            res = serve(cfg, params, dataclasses.replace(ecfg, data_plane=plane),
                        requests=requests, prompt_len=prompt_len, max_new=max_new,
                        seed=0, device="cuda")
        finally:
            ServingEngine._logits = plain_logits
        launches = ops.launch_counts()
        launches_by_path[f"{name}/{plane}-plane-{tag}"] = launches
        steps = res["steps"]
        kv = res["engine"].kv
        staged = plane == "batched"
        if kv.cfg.staged_migration != staged or (not staged and kv.flushes):
            fail(f"{name} reference phase: {plane} plane staged {kv.cfg.staged_migration}, "
                 f"{kv.flushes} flushes")
        check_launches(f"{name} reference phase, {plane} plane", launches, kv, L,
                       steps, requests)
        runs[plane] = {"tokens": res["tokens"], "ms_per_step": res["ms_per_step"],
                       "steps": steps, "stats": res["stats"], "launches": launches}
        res["engine"].kv.pool.check_invariants()
        del res, kv
    ref, bat = runs["reference"], runs["batched"]
    rids = sorted(ref["tokens"])
    if sorted(bat["tokens"]) != rids or any(
            len(r["tokens"][rid]) != max_new for r in (ref, bat) for rid in rids):
        fail(f"{name} reference phase: malformed tokens")
    firsts = {rid: next(i for i, (a, b) in enumerate(zip(ref["tokens"][rid],
                                                           bat["tokens"][rid])) if a != b)
              for rid in rids if ref["tokens"][rid] != bat["tokens"][rid]}
    verdict = "equal"
    if firsts:  # (request, step of its first difference, reference top-2 logit gap there)
        diffs = []
        for rid, step in sorted(firsts.items()):
            rows = [row for s, row in recorded if s == step]
            gap = float("inf")
            if len(rows) == len(rids):
                top2 = torch.topk(rows[rids.index(rid)].float(), 2).values
                gap = float(top2[0] - top2[1])
            diffs.append((rid, step, gap))
        log(f"[reference] tokens differ between the planes; (request, decode step of its "
            f"first difference, reference top-2 logit gap there): {diffs}")
        # a near-tie excuses the one request it occurs in, from that step on
        if len(diffs) > 1:
            fail(f"{name}: reference plane tokens differ from the batched plane's in "
                 f"{len(diffs)} requests: {diffs}")
        rid, step, gap = diffs[0]
        if not gap < NEAR_TIE:
            fail(f"{name}: reference plane tokens differ from the batched plane's at step "
                 f"{step} (request {rid}) with a top-2 logit gap of {gap} >= {NEAR_TIE}")
        verdict = (f"near-tie at step {step} of request {rid}, gap {gap}; every other "
                   "request equal")
    places = {p: {k: r["stats"][k] for k in (*PLACEMENT, "migrated_bytes")}
              for p, r in runs.items()}
    if places["reference"] != places["batched"]:
        fail(f"{name} reference phase: the planes placed pages differently: {places}")
    if placement is not None and {k: places["batched"][k] for k in placement} != placement:
        fail(f"{name} reference phase: placement {places['batched']}, expected {placement}")
    log(f"[reference] {name} full width, {requests} requests, prompt "
        f"{prompt_len}, {max_new} new tokens, top-k pages {ecfg.topk_pages}, windows "
        f"{sorted({s.attn.window or 0 for s in cfg.all_specs()})}: reference plane "
        f"{ref['ms_per_step']:.3f} ms/step, batched plane {bat['ms_per_step']:.3f} "
        f"ms/step; tokens {verdict}; placement {json.dumps(places['batched'])}")
    log(f"[reference] summary " + json.dumps({
        p: {k: v for k, v in r.items() if k != "tokens"} for p, r in runs.items()}))
    return launches_by_path


def smoke_lifecycle(torch, arch, qos=False, **overrides):
    """The smoke config's scripted lifecycle on cuda and on cpu: every
    observable field must be equal.  ``overrides`` change the engine
    config (``data_plane``, ``policy``); ``qos`` runs the two-tenant QoS
    lifecycle instead, which must shed a batch request on both devices."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import TppConfig
    from repro_torch.launch.serve import lifecycle_trace, qos_lifecycle_trace
    from repro_torch.models.model import init_params, tree_map
    from repro_torch.qos import QosConfig
    from repro_torch.serving import EngineConfig, ServingEngine

    scfg = get_smoke_config(arch)
    sparams = init_params(scfg, torch.Generator().manual_seed(0), device="cpu")
    if qos:
        secfg = EngineConfig(page_size=4, num_fast=8, num_slow=64, topk_pages=None,
                             tpp=TppConfig(demote_budget=4, promote_budget=2),
                             qos=QosConfig(mode="static", shares=(0.9, 0.1)))
        trace_fn, label = qos_lifecycle_trace, "qos"
    else:
        secfg = EngineConfig(page_size=4, num_fast=10, num_slow=64, recent_pages=1,
                             topk_pages=2,
                             tpp=TppConfig(demote_budget=16, promote_budget=8),
                             **overrides)
        trace_fn, label = lifecycle_trace, f"{secfg.policy}/{secfg.data_plane}"
    traces, checks = {}, {}
    devices = ("cuda", "cpu")
    for dev in devices:
        p = sparams if dev == "cpu" else tree_map(lambda t: t.to("cuda"), sparams)
        eng = ServingEngine(scfg, p, secfg, device=dev)
        traces[dev] = trace_fn(eng, scfg.vocab)
        san = eng.kv.pool.tiersan
        if san is None or san.level != "full" or not eng.kv.plan_check:
            fail(f"{arch} {label} smoke lifecycle on {dev} ran without TierSan "
                 "and the plan check")
        checks[dev] = (san.checks, eng.kv.flushes)
    card, host = (traces[d] for d in devices)
    for field in host:
        a, b = card[field], host[field]
        if a != b:
            first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None) \
                if isinstance(a, list) else None
            fail(f"{arch} {label} smoke lifecycle cuda != cpu in {field!r}"
                 + (f" at index {first}: {a[first]} vs {b[first]}" if first is not None
                    else f": {a} vs {b}"))
    if checks["cuda"] != checks["cpu"] or checks["cuda"][0] == 0:
        fail(f"{arch} {label}: TierSan checks and flushes {checks}")
    vm = card["vmstat"]
    moved = vm["pgdemote_total"] + vm["pgpromote_total"]
    if secfg.policy == "linux" and moved:
        fail(f"{arch} {label} smoke lifecycle migrated {moved} pages")
    if secfg.policy == "numa_balancing" and vm["pgdemote_total"]:
        fail(f"{arch} {label} smoke lifecycle demoted")
    if secfg.policy in ("tpp", "autotiering") and vm["pgdemote_total"] <= 0:
        fail(f"{arch} {label} smoke lifecycle did not demote")
    if qos and not card["shed_at_steps"]:
        fail(f"{arch} {label} smoke lifecycle shed no batch request")
    log(f"[serve] {arch} {label} smoke lifecycle cuda == cpu: "
        f"{sum(len(t) for t in card['tokens'])} tokens, "
        f"demoted {vm['pgdemote_total']}, promoted {vm['pgpromote_total']}, "
        f"TierSan checks {checks['cuda'][0]}, flushes checked {checks['cuda'][1]}"
        + (f", batch shed at steps {card['shed_at_steps']}, qos "
           f"{json.dumps(card['stats'][-1]['qos'])}" if qos else ""))


@contextlib.contextmanager
def counted(torch, sched, timings=None):
    """Count (and with ``timings``, time) ``sched``'s generate steps and
    prefills while the block runs.  Each generate and each prefill is
    timed between two synchronises (wall ms of a generate by padded
    batch ``Bp``); yields the counts: the generate steps that decoded at
    least one lane and the prefills that ran."""
    from repro_torch.serving.kv_cache import bucket

    slots = sched.slots
    sync = torch.cuda.synchronize if sched.engine.device.type == "cuda" else (lambda: None)
    plain_generate, plain_prefill = slots.generate, slots.prefill
    counts = {"decodes": 0, "prefills": 0}

    def generate():
        B = sum(1 for s in slots.occupied() if not s.paused)
        sync()
        t0 = time.perf_counter()
        out = plain_generate()
        sync()
        if B:
            counts["decodes"] += 1
            if timings is not None:
                timings["generate_ms"].setdefault(bucket(B), []).append(
                    1e3 * (time.perf_counter() - t0))
        return out

    def prefill(*args, **kwargs):
        sync()
        t0 = time.perf_counter()
        rid = plain_prefill(*args, **kwargs)  # an AdmissionError runs no kernel
        sync()
        counts["prefills"] += 1
        if timings is not None:
            timings["prefill_ms"].append(1e3 * (time.perf_counter() - t0))
        return rid

    slots.generate, slots.prefill = generate, prefill
    try:
        yield counts
    finally:
        slots.generate, slots.prefill = plain_generate, plain_prefill


def traffic_run(torch, sched, timings=None):
    """Drive ``sched`` to its end, counted (``counted``); returns the
    result and the counts."""
    with counted(torch, sched, timings) as counts:
        res = sched.run()
    return res, counts


def traffic_phase(torch, cfg, params, smi):
    """The continuous-batching front end (``repro_torch.traffic``) over
    full-width ``cfg`` on the card (``params``, seeded 0), with the
    traffic benchmark's engine (``topk_pages=None`` but in the two-plane
    run):

    1. Poisson and MMPP traces of 56 requests × relief ``shed`` and
       ``control``: each ``summary()``, and the local fraction, demoted
       and promoted of ``stats()``, equal to the smoke config's run of
       the same trace on the CPU (exact attention makes them depend on
       no weight); launch counts exact (``check_launches``).
    2. The Poisson/``control`` trace with top-4 pages on the batched and
       on the reference plane: ``completed`` tokens equal (a difference
       fails with the reference decode's top-2 logit gap at each first
       difference, as its diagnosis).
    3. The card's own wall times (synchronised generate by ``Bp``,
       prefill, run) and a ``torch.profiler`` trace of 8 generate steps
       of the MMPP/``control`` run, printed as ``measured``; the
       scheduler's TTFT and TPOT as ``modeled_ms``.

    Returns ``(launches_by_path, flush_pairs)``."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.benchmarks import traffic_bench as tb
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import Tier
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import trace_kernel_launches
    from repro_torch.models.model import init_params, tree_map

    name, L = "tinyllama-1.1b", cfg.n_layers
    scfg = get_smoke_config(name)
    ecfg = dataclasses.replace(tb.ENGINE_CONFIG, topk_pages=None)
    sparams = init_params(scfg, torch.Generator().manual_seed(0), device="cpu")
    vocab = min(cfg.vocab, scfg.vocab)  # one trace whose tokens both configs take
    placement_keys = ("local_fraction", "demoted", "promoted")
    launches_by_path, flush_pairs = {}, Counter()
    timings = {"generate_ms": {}, "prefill_ms": []}
    run_s, modeled = {}, {}
    for kind in tb.KINDS:
        trace = tb.trace(kind, vocab)
        for relief in ("shed", "control"):
            key = f"{kind}_{relief}"
            host = tb.scheduler(scfg, sparams, trace, relief, ecfg, device="cpu").run()
            ops.reset_launch_counts()  # the cache's prewarm copy counts
            sched = tb.scheduler(cfg, params, trace, relief, ecfg, device="cuda")
            t0 = time.perf_counter()
            res, counts = traffic_run(torch, sched, timings)
            run_s[key] = time.perf_counter() - t0
            launches = ops.launch_counts()
            kv = sched.engine.kv
            check_launches(f"traffic {key}", launches, kv, L, counts["decodes"],
                           counts["prefills"])
            launches_by_path[f"{name}/traffic/{key}"] = launches
            flush_pairs.update(kv.flush_pairs)
            summary = res.summary()
            if summary != host.summary():
                fail(f"traffic {key}: the card's summary {json.dumps(summary)} != the "
                     f"CPU smoke run's {json.dumps(host.summary())}")
            got = {k: res.engine_stats[k] for k in placement_keys}
            want = {k: host.engine_stats[k] for k in placement_keys}
            if got != want:
                fail(f"traffic {key}: stats {got} != the CPU smoke run's {want}")
            if counts["prefills"] != sum(r.attempts for r in sched.records.values()):
                fail(f"traffic {key}: {counts['prefills']} prefills for "
                     f"{sum(r.attempts for r in sched.records.values())} admissions")
            kv.pool.check_invariants()
            modeled[key] = {c: {k: v for k, v in m.items() if k.startswith(("ttft", "tpot"))}
                            for c, m in summary["per_class"].items()}
            log(f"[traffic] {key} summary {json.dumps(summary)}")
            log(f"[traffic] {key}: {summary['steps']} steps ({counts['decodes']} that "
                f"decoded), {counts['prefills']} prefills, stats {json.dumps(got)}, "
                f"{kv.flushes} flushes, launches "
                f"{json.dumps({k: n for k, n in launches.items() if n})}; equal to the "
                f"CPU smoke run")
            del sched, res, kv

    # both planes at the benchmark's own top-4 pages on one trace
    trace = tb.trace("poisson", vocab)
    completed, gaps = {}, {}
    for plane in ("batched", "reference"):
        ops.reset_launch_counts()
        sched = tb.scheduler(cfg, params, trace, "control",
                             dataclasses.replace(tb.ENGINE_CONFIG, data_plane=plane),
                             device="cuda")
        eng = sched.engine
        if plane == "reference":  # each decode's top-2 logit gap, in decode order
            plain_decode, plain_logits, at = eng._decode_one, eng._logits, {}

            def decode_one(seq, eng=eng, plain_decode=plain_decode, at=at):
                req = eng.requests[seq.rid]
                at["key"] = (tuple(req.prompt), len(req.out))
                return plain_decode(seq)

            def logits(x, plain_logits=plain_logits, at=at):
                out = plain_logits(x)
                top2 = torch.topk(out[0, -1].float(), 2).values
                gaps[at["key"]] = (len(gaps), float(top2[0] - top2[1]))
                return out

            eng._decode_one, eng._logits = decode_one, logits
        t0 = time.perf_counter()
        res, counts = traffic_run(torch, sched)
        run_s[f"poisson_control_topk4_{plane}"] = time.perf_counter() - t0
        launches = ops.launch_counts()
        check_launches(f"traffic two planes, {plane}", launches, eng.kv, L,
                       counts["decodes"], counts["prefills"])
        launches_by_path[f"{name}/traffic/poisson_control-topk4-{plane}-plane"] = launches
        completed[plane] = sched.completed
        log(f"[traffic] poisson_control top-4 pages, {plane} plane: summary "
            f"{json.dumps(res.summary())}")
        del sched, res, eng
    ref, bat = completed["reference"], completed["batched"]
    if sorted(ref) != sorted(bat):
        fail(f"traffic two planes: requests completed differ: {sorted(set(ref) ^ set(bat))}")
    diffs = []  # ((reference decode order, top-2 gap), request, token) of each first difference
    for i in sorted(ref):
        a, b = ref[i], bat[i]
        if a != b:
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            diffs.append((gaps.get((trace[i].prompt, j), (float("inf"), float("inf"))), i, j))
    if diffs:  # the top-2 gaps are the diagnosis; a near-tie is a fault all the same
        diffs.sort()
        fail(f"traffic two planes: completed tokens of {len(diffs)} requests differ; "
             "(reference decode order, top-2 logit gap there), request, token of each "
             f"first difference: {diffs[:8]}")
    log(f"[traffic] two planes, top-4 pages: {sum(len(t) for t in ref.values())} tokens of "
        f"{len(ref)} requests equal")

    # TierSan over one scheduler lifecycle at smoke size, cuda against cpu
    os.environ["TIERSAN_LEVEL"] = "full"
    os.environ["TIERSAN_PLAN_CHECK"] = "1"
    try:
        ends = []  # the card's run, then the CPU's
        strace = tb.trace("bursty", scfg.vocab)
        for dev in ("cuda", "cpu"):
            p = sparams if dev == "cpu" else tree_map(lambda t: t.to("cuda"), sparams)
            sched = tb.scheduler(scfg, p, strace, "control", device=dev)
            res = sched.run()
            eng = sched.engine
            pool = eng.kv.pool
            free = (pool.free_frames(Tier.FAST), pool.free_frames(Tier.SLOW))
            if eng.seqs or free != (ecfg.num_fast, ecfg.num_slow):
                fail(f"traffic TierSan lifecycle on {dev}: {len(eng.seqs)} sequences and "
                     f"free frames {free} at the end")
            if pool.tiersan is None or pool.tiersan.level != "full" or not eng.kv.plan_check:
                fail(f"traffic TierSan lifecycle on {dev} ran without TierSan")
            ends.append((res.summary(), sched.completed, res.engine_stats,
                         pool.tiersan.checks, eng.kv.flushes))
        if ends[0] != ends[1]:
            fail("traffic TierSan lifecycle: cuda != cpu")
        log(f"[traffic] MMPP/control smoke lifecycle under TierSan cuda == cpu: "
            f"{ends[0][0]['steps']} steps, TierSan checks {ends[0][3]}, "
            f"flushes checked {ends[0][4]}, every frame free at the end")
    finally:
        del os.environ["TIERSAN_LEVEL"], os.environ["TIERSAN_PLAN_CHECK"]

    # 8 generate steps of the MMPP/control run under the profiler
    sched = tb.scheduler(cfg, params, tb.trace("bursty", vocab), "control", ecfg,
                         device="cuda")
    sched.run(max_steps=40)
    out_dir = ROOT / "build" / "profile" / "traffic"
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.run(max_steps=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in ka if e.device_type.name == "CUDA")
    prof.export_chrome_trace(str(out_dir / "trace.json"))
    steps = sched.steps - 40
    top = sorted((e for e in ka if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:8]
    measured = {
        "card": smi,
        "generate_ms_by_Bp": {
            bp: {"calls": len(v), "mean": sum(v) / len(v), "median": sorted(v)[len(v) // 2],
                 "min": min(v), "max": max(v)}
            for bp, v in sorted(timings["generate_ms"].items())},
        "prefill_ms": {"calls": len(timings["prefill_ms"]),
                       "mean": sum(timings["prefill_ms"]) / len(timings["prefill_ms"]),
                       "median": sorted(timings["prefill_ms"])[len(timings["prefill_ms"]) // 2]},
        "run_s": run_s,
        "profile_8_steps": {
            "traced_generate_steps": steps,
            "wall_ms_per_step": 1e3 * wall / steps,
            "device_busy_ms_per_step": device_us / 1e3 / steps,
            "device_idle_share": 1.0 - device_us / 1e6 / wall,
            "device_launches_per_step": trace_kernel_launches(out_dir / "trace.json") / steps,
            "top_device_ops_ms_per_step": {e.key: e.self_device_time_total / 1e3 / steps
                                           for e in top}},
    }
    log(f"[traffic] measured (wall times between synchronises; the 56-request runs of "
        f"step 1) {json.dumps(measured)}")
    log(f"[traffic] modeled_ms (the scheduler's latency clock, not the card's) "
        f"{json.dumps(modeled)}")
    del sched
    gc.collect()
    torch.cuda.empty_cache()
    return launches_by_path, flush_pairs


# the serving fleet: two hosts of one KV shard each, (trace kind, relief);
# relief "control" never drains at the greedy split's 12 fast frames
# (batch evictions restart without end, in the JAX package alike)
FLEET_HOSTS = (("bursty", "shed"), ("poisson", "shed"))
FLEET_BUDGET = 24  # of the two engines' 32 fast frames
FLEET_CHUNK = 16  # generate steps of each host between coordinator ticks
FLEET_MESH_RANKS = 2


def drained(sched) -> bool:
    return not (sched.queue or sched.slots.occupied() or sched._next < len(sched.trace))


def fleet_run(torch, scheds, mode, timings=None):
    """One serving fleet: each scheduler's engine joins as a KV shard of
    its own host (``as_shard_pool(host=h, traffic=sched)``) under one
    coordinator with the fleet mesh.  The greedy split is pushed; then
    each round runs ``HostShard.step(FLEET_CHUNK)`` on every host and,
    in ``coordinated`` mode, one ``tick()`` until both schedulers drain
    (``FleetSimulator.run``'s loop over traffic shards).  Fleet
    conservation is checked after every push and each tick's mesh
    reduction against numpy.  Returns the coordinator, the greedy
    split, each scheduler's generate/prefill counts and the mesh
    reductions."""
    import numpy as np

    from repro_torch.analysis.tiersan import check_fleet_conservation
    from repro_torch.fleet import (FleetCoordinator, FleetCoordinatorConfig, HostShard,
                                   coordinator)

    hosts = [HostShard(h, [s.engine.as_shard_pool(host=h, traffic=s)])
             for h, s in enumerate(scheds)]
    coord = FleetCoordinator([h.pools[0] for h in hosts], FLEET_BUDGET,
                             FleetCoordinatorConfig(use_mesh=True))
    greedy = [int(b) for b in coord.initial_budgets()]
    coord.push(np.asarray(greedy))
    check_fleet_conservation(coord)
    plain_reduce, reductions = coordinator.mesh_reduce_telemetry, []

    def reduce(rows):
        got = plain_reduce(rows)
        if got is None or not np.array_equal(got, np.asarray(rows).sum(axis=0)):
            fail(f"fleet {mode}: the mesh reduced {np.asarray(rows).tolist()} to {got}")
        reductions.append(got.tolist())
        return got

    coordinator.mesh_reduce_telemetry = reduce
    with contextlib.ExitStack() as stack:
        counts = [stack.enter_context(counted(torch, s, t))
                  for s, t in zip(scheds, timings or [None] * len(scheds))]
        try:
            while True:
                for h in hosts:
                    h.step(FLEET_CHUNK)
                if all(drained(s) for s in scheds):
                    break
                if mode == "coordinated":
                    coord.tick()
                    check_fleet_conservation(coord)
        finally:
            coordinator.mesh_reduce_telemetry = plain_reduce
    return coord, greedy, counts, reductions


def fleet_view(coord, scheds):
    """What a fleet run must reproduce: the coordinator's summary and,
    per scheduler, its summary, the engine's stats (migrated bytes as
    pages) and the completions by request and length (the tokens follow
    the weights)."""
    out = [coord.summary()]
    for s in scheds:
        stats = dict(s.engine.stats())
        stats["migrated_pages"] = stats.pop("migrated_bytes") // s.engine.kv.cfg.page_bytes
        out.append((s.result().summary(), stats,
                    {i: len(toks) for i, toks in sorted(s.completed.items())}))
    return out


def fleet_phase(torch, cfg, params, smi):
    """A fleet of two full-width ``cfg`` serving engines on the card (phase
    4's weights ``params``, the traffic benchmark's engine with exact
    attention), one KV shard a host, in ``greedy`` and ``coordinated``
    mode (``fleet_run``).  Each mode must equal the same fleet at the
    smoke config on the CPU (``fleet_view``), a coordinated tick must move
    a budget off the greedy split, launch counts must be exact over both
    engines, the pools must pass ``check_invariants``.  Prints the wall
    seconds, ms per generate per host and the flush histogram; returns
    the launches by path."""
    from collections import Counter

    from repro_torch.benchmarks import traffic_bench as tb
    from repro_torch.configs import get_smoke_config
    from repro_torch.fleet import host_device_count, request_host_devices
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params

    name, L = "tinyllama-1.1b", cfg.n_layers
    scfg = get_smoke_config(name)
    ecfg = dataclasses.replace(tb.ENGINE_CONFIG, topk_pages=None)
    sparams = init_params(scfg, torch.Generator().manual_seed(0), device="cpu")
    vocab = min(cfg.vocab, scfg.vocab)  # one trace each that both configs take
    traces = [tb.trace(kind, vocab) for kind, _ in FLEET_HOSTS]
    if not request_host_devices(FLEET_MESH_RANKS) or host_device_count() != FLEET_MESH_RANKS:
        fail(f"fleet: no mesh of {FLEET_MESH_RANKS} ranks (have {host_device_count()})")

    def schedulers(c, p, device):
        return [tb.scheduler(c, p, tr, relief, ecfg, device=device)
                for tr, (_, relief) in zip(traces, FLEET_HOSTS)]

    launches_by_path, measured = {}, {"card": smi}
    for mode in ("greedy", "coordinated"):
        host_scheds = schedulers(scfg, sparams, "cpu")
        host_coord, _, _, _ = fleet_run(torch, host_scheds, mode)
        want = fleet_view(host_coord, host_scheds)
        ops.reset_launch_counts()  # the caches' prewarm copies count
        scheds = schedulers(cfg, params, "cuda")
        timings = [{"generate_ms": {}, "prefill_ms": []} for _ in scheds]
        t0 = time.perf_counter()
        coord, greedy, counts, reductions = fleet_run(torch, scheds, mode, timings)
        wall_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        got = fleet_view(coord, scheds)
        if got != want:
            diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            fail(f"fleet {mode}: the card's fleet differs from the CPU smoke fleet in "
                 f"{['coordinator' if i == 0 else f'host {i - 1}' for i in diff]}: "
                 f"{json.dumps(got)} != {json.dumps(want)}")
        expected = Counter()
        for s, c in zip(scheds, counts):
            expected.update(expected_launches(s.engine.kv, L, c["decodes"], c["prefills"]))
            if c["prefills"] != sum(r.attempts for r in s.records.values()):
                fail(f"fleet {mode}: {c['prefills']} prefills for "
                     f"{sum(r.attempts for r in s.records.values())} admissions")
            s.engine.kv.pool.check_invariants()
        wrong = {k: (launches[k], n) for k, n in expected.items() if launches[k] != n}
        if wrong:
            fail(f"fleet {mode}: launches (counted, expected) over both engines: {wrong}")
        timeline = coord.summary()["timeline"]
        moved = [e["tick"] for e in timeline if e["budgets"] != greedy]
        if mode == "coordinated" and (not moved or len(reductions) != len(timeline)):
            fail(f"fleet coordinated: no tick moved a budget off the greedy split "
                 f"{greedy}, or {len(reductions)} mesh reductions for {len(timeline)} "
                 f"ticks: {json.dumps(timeline)}")
        launches_by_path[f"{name}/fleet/{mode}"] = launches
        flushes = Counter()
        for s in scheds:
            flushes.update(s.engine.kv.flush_pairs)
        measured[mode] = {
            "wall_s": wall_s,
            "generate_ms_by_host": [
                {"calls": sum(len(v) for v in t["generate_ms"].values()),
                 "mean": (sum(sum(v) for v in t["generate_ms"].values())
                          / max(1, sum(len(v) for v in t["generate_ms"].values()))),
                 "mean_by_Bp": {bp: sum(v) / len(v) for bp, v in sorted(t["generate_ms"].items())}}
                for t in timings],
            "prefill_ms_by_host": [sum(t["prefill_ms"]) / max(1, len(t["prefill_ms"]))
                                   for t in timings],
            "steps": [s.steps for s in scheds], "decodes": [c["decodes"] for c in counts],
            "prefills": [c["prefills"] for c in counts],
            "flush_pairs_histogram": {str(k): v for k, v in sorted(flushes.items())},
            "budgets": [p.budget for p in coord.pools], "ticks": coord.ticks,
            "ticks_off_greedy": moved, "mesh_reductions": len(reductions),
        }
        log(f"[fleet] {mode}: {json.dumps(measured[mode])}; coordinator, summaries and "
            f"stats equal to the CPU smoke fleet; launches "
            f"{json.dumps({k: n for k, n in launches.items() if n})}")
        log(f"[fleet] {mode} timeline {json.dumps(timeline)}")
        del scheds, coord, host_scheds, host_coord
    log(f"[fleet] measured (wall times between synchronises) {json.dumps(measured)}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches_by_path


# the expert tier's counts on the benchmark's phi3.5 stream (8 layers, 16
# experts, top-2, 51 fast, 120 steps): (hbm fraction, modeled cost,
# promoted, demoted), as the JAX manager gives them
EXPERT_COUNTS = {"linux": (0.0, 15360.0, 0, 0), "autotiering": (0.804, 4559.0, 207, 158),
                 "tpp": (0.765, 5084.0, 205, 157)}
EXPERT_STEPS = 120
EXPERT_FLEET_STEPS = 40  # the tpp stream's steps after it joins a fleet
HOST_LINK_GBPS = 64.0  # PCIe Gen5 x16, nominal, each direction


def expert_tier_phase(torch, moe_cfg, smi):
    """The expert tier (``repro_torch.serving.expert_tier``) at phi3.5-moe's
    published expert widths: a device bank of 51 experts in HBM and a
    pinned host bank of every expert, on the stream of
    ``repro_torch.benchmarks.expert_tiering`` for each policy.  The counts
    must equal the CPU's at tiny widths and, unless host memory cut L,
    ``EXPERT_COUNTS``; after each policy every expert, wherever it lives,
    equals its generator's output bit for bit.  Prints the host link's measured rates and the lookup
    times."""
    import numpy as np

    from repro_torch.benchmarks import expert_tiering as eb
    from repro_torch.core import Tier

    _, L, E, K, frac = eb.CASES[0]
    mcfg = moe_cfg.all_specs()[0].moe
    d, f = moe_cfg.d_model, mcfg.d_ff_expert
    shapes = {"wi_gate": (d, f), "wi_up": (d, f), "wo": (f, d)}
    per_expert = 4 * sum(a * b for a, b in shapes.values())
    mem_avail = meminfo_bytes("MemAvailable")
    full_L = L
    while L > 1 and mem_avail < 1.5 * L * E * per_expert:
        L -= 1
    if L != full_L:
        log(f"[expert_tier] reduced: L cut from {full_L} to {L}: MemAvailable "
            f"{mem_avail} B < 1.5 x the {full_L * E * per_expert} B slow bank; "
            f"EXPERT_COUNTS (L={full_L}) not compared")
    # counts at this L and tiny widths on the CPU (they depend on no weight)
    host = {}
    for policy in eb.POLICIES:
        tiny = {k: np.zeros((L, E, 2, 3), np.float32) for k in shapes}
        mgr = eb.manager(L, E, frac, policy, tiny, device="cpu")
        eb.drive(mgr, K, EXPERT_STEPS)
        host[policy] = expert_counts(mgr)
        if policy == "tpp":
            host["tpp/fleet"] = expert_fleet(mgr, K)
    compared = "the CPU's" + (" and EXPERT_COUNTS" if L == full_L else "")

    def expert(le):
        """Expert ``le``'s weights, made on the card from its own generator."""
        g = torch.Generator(device="cuda").manual_seed(1000 + le)
        return {k: torch.randn(s, generator=g, device="cuda") for k, s in shapes.items()}

    # each manager copies its weights into a pinned bank of its own: given
    # zeros as stride-0 views, it pins and zeroes the bank, and the experts
    # are then written into its rows from the card (no second 40 GB copy)
    zeros = {k: torch.zeros(s).expand((L, E) + s) for k, s in shapes.items()}
    out = {"card": smi, "L": L, "E": E, "top_k": K, "expert_bytes": per_expert,
           "host_link_nominal_GBps": HOST_LINK_GBPS}

    def check_payloads(mgr, label):
        """Every expert where it lives, against its generator, bit for bit."""
        wrong = []
        for (l, e), pid in mgr.pid_of.items():
            page = mgr.pool.pages[pid]
            bank = mgr.fast_bank if page.tier == Tier.FAST else mgr.slow_bank
            for k, w in expert(l * E + e).items():
                if not torch.equal(bank[k][page.frame].to("cuda"), w):
                    wrong.append((l, e, k))
        if wrong:
            fail(f"expert tier {label}: payloads differ from their generators: {wrong[:8]}")

    def run_policy(policy):
        """One policy's run; returns a weak reference to its slow bank."""
        t0 = time.perf_counter()
        mgr = eb.manager(L, E, frac, policy, zeros, device="cuda")
        build_s = time.perf_counter() - t0
        mem_after = meminfo_bytes("MemAvailable")
        if not all(b.is_pinned() for b in mgr.slow_bank.values()):
            fail(f"expert tier {policy}: the slow bank is not in pinned memory")
        t0 = time.perf_counter()
        for le in range(L * E):
            for k, w in expert(le).items():
                mgr.slow_bank[k][le].copy_(w)
        fill_s = time.perf_counter() - t0
        log(f"[expert_tier] {policy} banks: {len(shapes)} pinned host tensors of "
            f"(L·E={L * E}) experts at d={d}, d_ff_expert={f}: {L * E * per_expert} B "
            f"({per_expert} B an expert); built (pinned and zeroed) in {build_s:.3f} s "
            f"(MemAvailable {mem_avail} -> {mem_after} B), filled from the card in "
            f"{fill_s:.3f} s; HBM bank {mgr.cfg.fast_capacity} experts, "
            f"{mgr.cfg.fast_capacity * per_expert} B")
        moved = {Tier.FAST: [0, 0.0], Tier.SLOW: [0, 0.0]}  # by source tier
        plain_migrate = mgr.pool.on_migrate

        def timed_migrate(pid, src, src_frame, dst, dst_frame):
            t0 = time.perf_counter()
            plain_migrate(pid, src, src_frame, dst, dst_frame)
            torch.cuda.synchronize()
            moved[src][0] += per_expert
            moved[src][1] += time.perf_counter() - t0

        mgr.pool.on_migrate = timed_migrate
        t0 = time.perf_counter()
        eb.drive(mgr, K, EXPERT_STEPS)
        torch.cuda.synchronize()
        drive_s = time.perf_counter() - t0
        got = expert_counts(mgr)
        rec = (round(got["fast_fraction"], 3), got["modeled_cost"],
               got["vmstat"]["pgpromote_total"], got["vmstat"]["pgdemote_total"])
        if got != host[policy] or (L == full_L and rec != EXPERT_COUNTS[policy]):
            fail(f"expert tier {policy}: counts {got} differ from the CPU's "
                 f"{host[policy]}, or {rec} from the recorded {EXPERT_COUNTS[policy]}")
        check_payloads(mgr, policy)
        if policy == "tpp":  # the manager joins a one-shard fleet, before the
            # lookups below touch it; its copies stay out of the host-link rates
            mgr.pool.on_migrate = plain_migrate
            t0 = time.perf_counter()
            shard = expert_fleet(mgr, K)
            torch.cuda.synchronize()
            fleet_s = time.perf_counter() - t0
            mgr.pool.on_migrate = timed_migrate
            if shard != host["tpp/fleet"]:
                fail(f"expert tier tpp as a fleet shard: counts {shard} differ from the "
                     f"CPU's {host['tpp/fleet']}")
            check_payloads(mgr, "tpp as a fleet shard")
            out["tpp/fleet"] = {k: shard[k] for k in ("budget", "hbm_hits", "host_hits",
                                                        "fast_fraction", "modeled_cost")}
            out["tpp/fleet"]["s"] = fleet_s
            log(f"[expert_tier] tpp as shard h2/experts of a one-shard fleet, budget "
                f"{shard['budget']} of {mgr.cfg.fast_capacity} HBM experts, "
                f"{EXPERT_FLEET_STEPS} more steps: counts equal to the CPU's; every payload "
                f"bit for bit; {json.dumps(out['tpp/fleet'])}")
        # lookups: the manager's call, then one read of the expert where it
        # is (an HBM reduction) or a host gather (a copy over the link)
        look = {}
        for tier in (Tier.FAST, Tier.SLOW):
            les = [le for le in range(L * E)
                   if mgr.pool.pages[mgr.pid_of[(le // E, le % E)]].tier == tier][:4]
            call_us, read_ms = [], []
            for le in les:
                t0 = time.perf_counter()
                rows, _ = mgr.lookup(le // E, le % E)
                call_us.append(1e6 * (time.perf_counter() - t0))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if tier == Tier.FAST:
                    [torch.sum(v) for v in rows.values()]
                else:
                    [v.to("cuda") for v in rows.values()]
                torch.cuda.synchronize()
                read_ms.append(1e3 * (time.perf_counter() - t0))
            if les:
                look[tier.name.lower()] = {"lookups": len(les),
                                           "lookup_call_us": sum(call_us) / len(les),
                                           "read_once_ms": sum(read_ms) / len(les),
                                           "read": "torch.sum of each weight on the card"
                                           if tier == Tier.FAST else "copy to the card"}
        out[policy] = {
            "build_s": build_s, "fill_s": fill_s, "hbm_fraction": got["fast_fraction"],
            "modeled_cost": got["modeled_cost"],
            "promoted": rec[2], "demoted": rec[3], "drive_s": drive_s,
            "promote_h2d": {"bytes": moved[Tier.SLOW][0], "s": moved[Tier.SLOW][1],
                            "GBps": moved[Tier.SLOW][0] / moved[Tier.SLOW][1] / 1e9
                            if moved[Tier.SLOW][1] else None},
            "demote_d2h": {"bytes": moved[Tier.FAST][0], "s": moved[Tier.FAST][1],
                           "GBps": moved[Tier.FAST][0] / moved[Tier.FAST][1] / 1e9
                           if moved[Tier.FAST][1] else None},
            "lookups": look,
        }
        log(f"[expert_tier] {policy}: counts {rec} equal to {compared}; every payload "
            f"bit for bit; measured {json.dumps(out[policy])}")
        return weakref.ref(next(iter(mgr.slow_bank.values())))

    for policy in eb.POLICIES:
        bank = run_policy(policy)
        gc.collect()
        torch.cuda.empty_cache()
        if bank() is not None:  # the next policy pins a bank of its own
            fail(f"expert tier {policy}: the slow bank outlived its manager")
    log(f"[expert_tier] measured {json.dumps(out)}")
    gc.collect()
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()  # the pinned blocks go back to the system
    return out


def expert_fleet(mgr, K):
    """``mgr`` joins a one-shard fleet (``as_shard_pool(host=2)``) with a
    global budget of 80% of its HBM experts and ``min_budget`` 8, takes
    the push-down and serves ``EXPERT_FLEET_STEPS`` more steps of the
    benchmark's stream; returns its counts, conservation checked after
    the push and at the end."""
    from repro_torch.analysis.tiersan import check_fleet_conservation
    from repro_torch.benchmarks import expert_tiering as eb
    from repro_torch.fleet import FleetCoordinator, FleetCoordinatorConfig

    shard = mgr.as_shard_pool(host=2)
    coord = FleetCoordinator([shard], int(0.8 * mgr.cfg.fast_capacity),
                             FleetCoordinatorConfig(min_budget=8))
    coord.push(coord.initial_budgets())
    check_fleet_conservation(coord)
    eb.drive(mgr, K, EXPERT_FLEET_STEPS)
    check_fleet_conservation(coord)
    mgr.pool.check_invariants()
    return {"key": shard.key, "budget": shard.budget, **expert_counts(mgr)}


def expert_counts(mgr):
    return {"hbm_hits": mgr.hbm_hits, "host_hits": mgr.host_hits,
            "fast_fraction": mgr.fast_fraction(), "modeled_cost": mgr.modeled_cost(),
            "placement": mgr.placement().tolist(), "vmstat": mgr.pool.vmstat.as_dict()}


# --------------------------------------------------------------------- #
# [train]: the training path
# --------------------------------------------------------------------- #
TRAIN_DATA = {"seq_len": 256, "global_batch": 8}  # the JAX CLI's defaults
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_WARMUP = 8, 4, 2
TRAIN_MOE_LAYERS = 2  # of 32: 11.5 GB of float32 weights, about 57 GB of state
# tinyllama's checkpointed run: 8 of 22 layers, 7.7 GB a checkpoint; the
# three it writes keep the script's disk writes near 23 GB (52.8 GB uncut)
TRAIN_CKPT_LAYERS = 8
TRAIN_SMOKE_LR = 1e-3
# cuda == cpu at smoke size: losses within 1e-5 relative and gradient norms
# within 1e-4 relative (float32 sums in another order); parameters within
# 2·lr a step everywhere (AdamW moves an element whose gradient is rounding
# noise by up to lr either way) and, over all parameters, the difference's
# norm within 1e-3 of the norm of what the three steps moved
TRAIN_SMOKE_TOL = {"loss_rel": 1e-5, "grad_norm_rel": 1e-4, "param_norm_rel": 1e-3}
TRAIN_GRAD_REL = 2e-5  # full-width MoE gradients, kernels vs plain autograd
DVALS_REL = 2e-5  # moe_combine_bwd's dvals: float32 dot products over d


def expected_train_launches(moe_layers, forwards, backwards):
    """A training run's MoE launches: route, dispatch and combine once an
    MoE layer a forward (remat runs each block's forward again in
    backward), the combine once more (the dispatch's backward) and
    ``moe_combine_bwd`` once an MoE layer a backward; nothing else."""
    f, b = moe_layers * forwards, moe_layers * backwards
    return {"paged_attention": 0, "page_gather": 0, "page_scatter": 0, "router_topk": 0,
            "flash_attention": 0, "moe_route": f, "moe_dispatch": f,
            "moe_combine": f + b, "moe_combine_bwd": b}


def check_train_launches(name, launches, expected, fails):
    if launches != expected:
        fails.append(f"{name}: launches {launches}, expected {expected}")


def biased_route(torch, gen, T, d, E, k, C):
    """A route where one expert is everyone's favourite, so experts overflow
    and assignments drop: x with a mean of 0.1, expert 0's router column
    raised by 0.01 (about +4 on its logit at d=4096)."""
    from repro_torch.kernels import ops

    x = torch.randn((T, d), generator=gen, device="cuda") + 0.1
    w = torch.randn((d, E), generator=gen, device="cuda") * 0.02
    w[:, 0] += 0.01
    return x, w, ops.moe_route(x, w, k, C, impl="kernel")


def check_moe_combine_bwd(torch, gen, flush, fails):
    """``moe_combine_bwd`` on the card against its plain version: ``dye``
    bit for bit, ``dvals`` within ``DVALS_REL`` of its largest magnitude
    (at least 1), at phi3.5-moe's training shape (T=2048 of B=8 × S=256,
    C=320) and decode shape (T=8, C=1) with tokens dropped,
    deepseek-v2-lite's router shape (T=4096, E=64, k=6, d=2048, C=480),
    and hand-made slots (unaligned d, empty slots, a token whose gates all
    drop); the dispatch's backward (``moe_combine`` with unit gates)
    exactly equal to its plain version; both timed beside the plain
    versions and the bytes bound.  Returns the kernels-line row."""
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import router_topk as rt

    cases = {}
    for name, (T, d, E, k, C) in {
            "phi3.5-moe train T=2048": (2048, 4096, 16, 2, 320),
            "phi3.5-moe decode T=8": (8, 4096, 16, 2, 1),
            "deepseek-v2-lite router T=4096": (4096, 2048, 64, 6, 480)}.items():
        x, w, r = biased_route(torch, gen, T, d, E, k, C)
        cases[name] = (x, w, r, torch.randn((E, C, d), generator=gen, device="cuda"),
                       torch.randn((T, d), generator=gen, device="cuda") * 1e-3)
    # hand-made: E=4, C=4, d=70 (the element loader), T=5, k=3; token 2's
    # gates all drop, and slots 3, 7, 11, 15 take no token
    E, C, d, T, k = 4, 4, 70, 5, 3
    slot = torch.tensor([0, 1, 2, 4, 5, 6, 16, 16, 16, 8, 9, 10, 12, 13, 16],
                        dtype=torch.int32, device="cuda")
    cases["edges E=4 C=4 d=70"] = (None, None, rt.Route(
        None, None, torch.rand((T, k), generator=gen, device="cuda"), None, slot, None,
        None, None), torch.randn((E, C, d), generator=gen, device="cuda"),
        torch.randn((T, d), generator=gen, device="cuda"))
    out, worst = {}, 0.0
    for name, (x, w, r, ye, dy) in cases.items():
        E, C, d = ye.shape
        dye, dvals = md.moe_combine_bwd(dy, ye, r.slot, r.vals)
        want_dye, want_dvals = md.moe_combine_bwd_plain(dy, ye, r.slot, r.vals)
        ones = torch.ones_like(r.vals)
        dx = md.moe_combine(dye, r.slot, ones)  # the dispatch's backward
        torch.cuda.synchronize()
        dropped = int((r.slot == E * C).sum())
        err = (dvals - want_dvals).abs().max().item()
        tol = DVALS_REL * max(1.0, want_dvals.abs().max().item())
        worst = max(worst, err)
        kept = set(r.slot[r.slot < E * C].tolist())
        empty = [s for s in range(E * C) if s not in kept]
        res = {"dropped": dropped, "empty_slots": len(empty), "dye_equal": torch.equal(
            dye, want_dye), "dvals_max_abs_err": err, "dvals_tolerance": tol,
            "dropped_dvals_zero": bool((dvals.reshape(-1)[r.slot == E * C] == 0).all()),
            "dispatch_backward_equal": torch.equal(dx, md.moe_combine_plain(dye, r.slot, ones))}
        out[name] = res
        if not (res["dye_equal"] and err <= tol and res["dropped_dvals_zero"]
                and res["dispatch_backward_equal"] and dropped > 0
                and bool(torch.isfinite(dvals).all())):
            fails.append(f"moe_combine_bwd {name}: {res}")
    log(f"[train] moe_combine_bwd checks {json.dumps(out)}")

    def times(x, w, r, ye, dy):
        E, C, d = ye.shape
        T, k = r.vals.shape
        kept = int((r.slot < E * C).sum())
        nbytes = 4 * (T * d + kept * d + 2 * T * k + E * C * d + T * k)
        b_ms, b_by = bound(nbytes, 3.0 * kept * d)
        ones = torch.ones_like(r.vals)
        src_rows = int(torch.unique(r.slot[r.slot < E * C]).numel())
        db_ms, db_by = bound(4 * (src_rows * d + T * k * 2 + T * d), float(kept * d))
        res = dict(
            kernel_ms=time_ms(torch, lambda: md.moe_combine_bwd(dy, ye, r.slot, r.vals), flush),
            plain_ms=time_ms(torch, lambda: md.moe_combine_bwd_plain(dy, ye, r.slot, r.vals),
                             flush),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
            bound_flops=3.0 * kept * d, kept_assignments=kept,
            dispatch_backward=dict(
                kernel_ms=time_ms(torch, lambda: md.moe_combine(ye, r.slot, ones), flush),
                plain_ms=time_ms(torch, lambda: md.moe_combine_plain(ye, r.slot, ones), flush),
                bound_ms=db_ms, bound_by=db_by))
        if x is not None:  # the route's backward: torch ops and two products
            probs = torch.softmax(x @ w, dim=-1)
            res["route_backward_ms"] = time_ms(torch, lambda: rt.route_backward(
                x, w, probs, r.vals, r.idx, r.counts, dy[:, :k].contiguous(),
                torch.ones((), device="cuda")), flush)
        return res

    timed = {name: times(*cases[name]) for name in list(cases)[:3]}
    main_t = timed["phi3.5-moe train T=2048"]
    row = {"name": "moe_combine_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/moe_dispatch.cu",
           "replaces": "src/repro/models/moe.py:133",
           "replaces_note": "no TPU kernel: XLA differentiates the combine at "
                            "src/repro/models/moe.py:133-135",
           "shape": "phi3.5-moe training: T=2048 (B=8 × S=256), d=4096, E=16, k=2, "
                    "C=320, tokens dropped",
           "max_abs_err": worst, "tolerance": DVALS_REL,
           "tolerance_note": "dvals: relative to max(1, max |dvals|) of each case; "
                             "dye bit for bit",
           "checks": len(cases), **main_t,
           "decode_T8": timed["phi3.5-moe decode T=8"],
           "deepseek_v2_lite_T4096_E64_k6": timed["deepseek-v2-lite router T=4096"]}
    del cases
    gc.collect()
    torch.cuda.empty_cache()
    return row


def plain_moe_fwd(torch, p, mcfg, x):
    """``moe_fwd`` through the plain versions' own torch ops, no
    ``autograd.Function``: the independent reference for the gradients."""
    import torch.nn.functional as F

    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import router_topk as rt

    B, S, d = x.shape
    T, E, K = B * S, mcfg.n_experts, mcfg.top_k
    xt = x.reshape(T, d)
    C = max(1, int(mcfg.capacity_factor * T * K / E))
    r = rt.moe_route_plain(xt, p["router"]["w"], K, C)
    xe = md.moe_dispatch_plain(xt, r.src, E, C)
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, p["wi_gate"])) * torch.einsum(
        "ecd,edf->ecf", xe, p["wi_up"])
    ye = torch.einsum("ecf,efd->ecd", h, p["wo"])
    return md.moe_combine_plain(ye, r.slot, r.vals).reshape(B, S, d), r.aux


def check_moe_gradients(torch, cfg, fails):
    """One phi3.5-moe layer at published widths: every gradient (router,
    experts, input) through the kernels' autograd within ``TRAIN_GRAD_REL``
    of each leaf's max-abs under the plain versions (``impl="ref"``) and
    under plain autograd of the plain ops, at T=2048 with a router biased
    so that assignments drop, and at decode (T=8, C=1); every gradient
    non-zero; the kernels' launches exact."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe

    mcfg = cfg.all_specs()[0].moe
    d = cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(9)
    p = moe.init_moe(gen, d, mcfg, device="cuda")
    with torch.no_grad():
        p["router"]["w"][:, 0] += 0.01
    names = ["router", "wi_gate", "wi_up", "wo", "x"]
    out = {}
    for case, (B, S) in {"T=2048 (B=8, S=256)": (8, 256), "decode T=8": (8, 1)}.items():
        x = torch.randn((B, S, d), generator=gen, device="cuda") + 0.1
        dy = torch.randn((B, S, d), generator=gen, device="cuda") * 1e-3
        grads = {}
        for impl in ("kernel", "ref", "plain autograd"):
            leaves = [p["router"]["w"], p["wi_gate"], p["wi_up"], p["wo"]]
            for t in leaves:
                t.requires_grad_(True)
            xx = x.clone().requires_grad_(True)
            ops.reset_launch_counts()
            if impl == "plain autograd":
                y, aux = plain_moe_fwd(torch, p, mcfg, xx)
            else:
                y, aux = moe.moe_fwd(p, mcfg, xx, impl=impl)
            grads[impl] = torch.autograd.grad((y * dy).sum() + 0.01 * aux, leaves + [xx])
            torch.cuda.synchronize()
            if impl == "kernel":
                check_train_launches(f"moe gradient {case}", ops.launch_counts(),
                                     expected_train_launches(1, 1, 1), fails)
            for t in leaves:
                t.requires_grad_(False)
        res = {}
        for ref in ("ref", "plain autograd"):
            for n, a, b in zip(names, grads["kernel"], grads[ref]):
                rel = ((a - b).abs().max() / b.abs().max()).item()
                res[f"{n} vs {ref}"] = rel
                if not rel <= TRAIN_GRAD_REL or not bool(b.abs().max() > 0):
                    fails.append(f"moe gradient {case}: {n} {rel} of its max-abs vs {ref}")
        T = B * S
        C = max(1, int(mcfg.capacity_factor * T * mcfg.top_k / mcfg.n_experts))
        r = ops.moe_route(x.reshape(T, d), p["router"]["w"], mcfg.top_k, C)
        res["dropped"] = int((r.slot == mcfg.n_experts * C).sum())
        if res["dropped"] <= 0:
            fails.append(f"moe gradient {case}: no assignment dropped")
        out[case] = res
        del grads
    log(f"[train] moe gradients, kernels vs plain (relative to each max-abs) "
        f"{json.dumps(out)}")
    del p
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tree_to(tree, device):
    from repro_torch.models import nn

    return nn.tree_map(lambda t: t.to(device), tree)


def train_smoke_phase(torch, arch, fails):
    """Three ``make_train_step`` steps of ``arch``'s smoke config on the
    card and on the CPU from the same weights and batches (plain, then
    ``accum=2``, then ``remat=True``): losses, gradient norms and final
    parameters held to ``TRAIN_SMOKE_TOL``; the MoE launches exact.
    Returns the card's launch counts."""
    from repro_torch import optim
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, make_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_train_step, to_device
    from repro_torch.models import nn
    from repro_torch.models.model import init_params

    cfg = get_smoke_config(arch)
    oc = optim.AdamWConfig(lr=TRAIN_SMOKE_LR)
    cpu_p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batches = make_batches(DataConfig(seq_len=32, global_batch=4, n_patches=4), cfg)
    batches = [next(batches) for _ in range(3)]
    kinds = [dict(), dict(accum=2), dict(remat=True)]
    runs = {}
    for dev in ("cpu", "cuda"):
        p = tree_to(cpu_p, dev)
        st = optim.init(p, oc)
        ops.reset_launch_counts()
        losses, gnorms = [], []
        for kw, b in zip(kinds, batches):
            p, st, m = make_train_step(cfg, oc, **kw)(p, st, to_device(b, dev))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            if int(m["skipped"]):
                fails.append(f"train smoke {arch} {dev}: a step was skipped")
        runs[dev] = (losses, gnorms, nn.tree_leaves(tree_to(p, "cpu")), ops.launch_counts())
    (l0, g0, p0, _), (l1, g1, p1, launches) = runs["cpu"], runs["cuda"]
    moved = torch.sqrt(sum(((a - b) ** 2).sum() for a, b in
                           zip(p0, nn.tree_leaves(cpu_p)))).item()
    diff = torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(p0, p1))).item()
    max_diff = max((a - b).abs().max().item() for a, b in zip(p0, p1))
    res = {"losses_cpu": l0, "losses_cuda": l1, "grad_norms_cpu": g0, "grad_norms_cuda": g1,
           "loss_rel": max(abs(a - b) / abs(a) for a, b in zip(l0, l1)),
           "grad_norm_rel": max(abs(a - b) / abs(a) for a, b in zip(g0, g1)),
           "param_norm_rel": diff / moved, "param_max_abs": max_diff}
    ok = (res["loss_rel"] <= TRAIN_SMOKE_TOL["loss_rel"]
          and res["grad_norm_rel"] <= TRAIN_SMOKE_TOL["grad_norm_rel"]
          and res["param_norm_rel"] <= TRAIN_SMOKE_TOL["param_norm_rel"]
          and max_diff <= 2 * TRAIN_SMOKE_LR * len(kinds))
    if not ok:
        fails.append(f"train smoke {arch}: cuda != cpu {res}")
    moe_layers = sum(1 for s in cfg.all_specs() if s.moe is not None)
    # forwards: 1, 2 (accum), 2 (remat recomputes); backwards 1, 2, 1
    check_train_launches(f"train smoke {arch}", launches,
                         expected_train_launches(moe_layers, 5, 4), fails)
    log(f"[train] smoke {arch} cuda vs cpu {json.dumps(res)}")
    return launches


def run_steps(step_fn, params, opt, batches, n):
    """``n`` steps on the card from the next ``n`` numpy batches, each timed
    as ``train_loop`` times it (to the host read of its loss) →
    ``(params, opt, losses, grad_norms, seconds, skipped)``."""
    from repro_torch.launch.train import to_device

    losses, gnorms, secs, skipped = [], [], [], 0
    for _ in range(n):
        b = next(batches)
        t0 = time.time()
        params, opt, m = step_fn(params, opt, to_device(b, "cuda"))
        losses.append(float(m["loss"]))
        secs.append(time.time() - t0)
        gnorms.append(float(m["grad_norm"]))
        skipped += int(m["skipped"])
    return params, opt, losses, gnorms, secs, skipped


def train_dense_phase(torch, smi, fails):
    """Full-width tinyllama-1.1b through ``train_loop`` at the JAX CLI's
    defaults (B=8, S=256), warmup 2, 8 steps: the loss must fall.  Then 4
    steps all on the card and 4 with the optimizer state's ``SLOW`` leaves
    (``plan_offload(opt, total // 3)``) in pinned host memory, equal bit
    for bit to each other and to the loop's first 4; then 2 traced
    steps.  Then the checkpoints: the same run cut to
    ``TRAIN_CKPT_LAYERS`` layers, a checkpoint every 4 steps into
    ``build/train_ckpt``, and a relaunch from step 4 whose losses,
    gradient norms and final state must equal the uninterrupted run's bit
    for bit (deterministic algorithms).  Returns the launch counts of the
    full-depth loop."""
    import shutil
    import statistics
    import warnings

    from repro_torch import optim
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.types import Tier
    from repro_torch.data import DataConfig, make_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_train_step, profile_train_steps, train_loop
    from repro_torch.models import nn
    from repro_torch.models.model import init_params, param_bytes
    from repro_torch.optim.offload import apply_placement, plan_offload

    cfg = get_config("tinyllama-1.1b")
    dcfg = DataConfig(**TRAIN_DATA)
    oc = optim.AdamWConfig()
    schedule = optim.cosine_schedule(TRAIN_WARMUP, TRAIN_STEPS)
    n_params = sum(t.numel() for t in _leaves(init_params(
        cfg, torch.Generator(), device="meta")))
    tokens = TRAIN_DATA["seq_len"] * TRAIN_DATA["global_batch"]

    def fresh(c):
        p = init_params(c, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        return p, optim.init(p, oc)

    def state_equal(a, b):
        return all(torch.equal(x, y.to(x.device)) for x, y in
                   zip(nn.tree_leaves(a), nn.tree_leaves(b)))

    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rep = train_loop(cfg, dcfg, oc, steps=TRAIN_STEPS, warmup=TRAIN_WARMUP,
                         log_every=0, device="cuda")
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()

        # 4 steps all on the card, then 4 with the optimizer state offloaded
        step_fn = make_train_step(cfg, oc, schedule, donate=True)
        batches = make_batches(dcfg, cfg)
        ref_p, ref_o, ref_l, ref_g, _, _ = run_steps(step_fn, *fresh(cfg), batches, 4)
        params, opt = fresh(cfg)
        total = sum(x.numel() * x.element_size() for x in nn.tree_leaves(opt))
        plan = plan_offload(opt, total // 3)
        opt = apply_placement(opt, plan)
        placed = dict(nn.tree_leaves_with_path(opt))
        slow = [placed[n] for n, t in plan.placement.items() if t == Tier.SLOW]
        slow_bytes = sum(x.numel() * x.element_size() for x in slow)
        pinned_ok = all(x.device.type == "cpu" and x.is_pinned() for x in slow) and all(
            placed[n].is_cuda for n, t in plan.placement.items() if t == Tier.FAST)
        params, opt, off_l, off_g, off_s, _ = run_steps(step_fn, params, opt,
                                                  make_batches(dcfg, cfg), 4)
        offload_equal = state_equal({"p": params, "o": opt}, {"p": ref_p, "o": ref_o})
        # the host link at these leaves: every SLOW leaf to the card and back
        dev_bufs = [torch.empty(x.shape, dtype=x.dtype, device="cuda") for x in slow]
        link = {}
        for way in ("host_to_device", "device_to_host"):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            for h, dbuf in zip(slow, dev_bufs):
                (dbuf.copy_(h, non_blocking=True) if way == "host_to_device"
                 else h.copy_(dbuf, non_blocking=True))
            ev[1].record()
            torch.cuda.synchronize()
            link[f"{way}_GBps"] = slow_bytes / (ev[0].elapsed_time(ev[1]) * 1e-3) / 1e9
        del dev_bufs, params, opt, slow, placed
        gc.collect()
        torch.cuda.empty_cache()
        # two traced steps (5 and 6), all state on the card
        prof = profile_train_steps(step_fn, ref_p, ref_o, batches, "cuda",
                                   str(ROOT / "build" / "profile" / "train_tinyllama-1.1b"))
        del ref_p, ref_o
        gc.collect()
        torch.cuda.empty_cache()

        # checkpoints and a relaunch, at a cut depth: a full-depth state is
        # 17.6 GB a checkpoint, and the run writes three
        pattern = cfg.stacks[0][0]
        ccfg = dataclasses.replace(cfg, stacks=((pattern, TRAIN_CKPT_LAYERS),))
        ckpt = ROOT / "build" / "train_ckpt"
        shutil.rmtree(ckpt, ignore_errors=True)
        kw = dict(steps=TRAIN_STEPS, ckpt_dir=str(ckpt), ckpt_every=TRAIN_CKPT_EVERY,
                  warmup=TRAIN_WARMUP, log_every=0, device="cuda")
        # a tree of the state's structure with a 0-element leaf on the card
        # wherever the state has one: restore() reads only structure and device
        meta_p = init_params(ccfg, torch.Generator(), device="meta")
        like = nn.tree_map(lambda t: torch.empty(0, dtype=t.dtype, device="cuda"),
                           {"params": meta_p, "opt": optim.init(meta_p, oc)})
        mgr = CheckpointManager(str(ckpt))
        rep_b = train_loop(ccfg, dcfg, oc, **kw)
        ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
        b_final = mgr.restore(TRAIN_STEPS, like)
        shutil.rmtree(ckpt / f"step_{TRAIN_STEPS:010d}")  # a relaunch finds step 4
        rep_c = train_loop(ccfg, dcfg, oc, **kw)
        restart_equal = state_equal(b_final, mgr.restore(TRAIN_STEPS, like))
        del b_final
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.use_deterministic_algorithms(False)
    gc.collect()
    torch.cuda.empty_cache()
    nondet = sorted({str(w.message).split("\n")[0] for w in caught
                     if "deterministic" in str(w.message)})

    med = statistics.median(rep.step_seconds)
    res = {
        "arch": "tinyllama-1.1b", "layers": cfg.n_layers, "params": n_params,
        "weight_bytes": param_bytes(cfg), "batch": TRAIN_DATA, "steps": TRAIN_STEPS,
        "losses": rep.losses, "grad_norms": rep.grad_norms,
        "step_seconds": rep.step_seconds, "median_ms_per_step": med * 1e3,
        "tokens_per_s": tokens / med,
        "fp32_peak_share": 6.0 * n_params * tokens / med / PEAK_FLOPS["float32"],
        "peak_device_memory_GiB": peak / 2**30, "wall_s": wall, "skipped": rep.skipped,
        "stragglers": rep.stragglers,
        "offload": {"hbm_budget_bytes": total // 3, "state_bytes": total,
                    "slow_leaves": len(plan.placement) - sum(
                        t == Tier.FAST for t in plan.placement.values()),
                    "slow_bytes": slow_bytes, "fraction_fast": plan.fraction_fast(),
                    "pinned": pinned_ok, "host_link_bytes_per_step_each_way": slow_bytes,
                    **link, "losses": off_l,
                    "losses_equal": off_l == ref_l == rep.losses[:4],
                    "grad_norms_equal": off_g == ref_g == rep.grad_norms[:4],
                    "state_equal": offload_equal,
                    "median_ms_per_step": statistics.median(off_s) * 1e3,
                    "no_offload_median_ms_per_step": med * 1e3},
        "relaunch": {"layers": TRAIN_CKPT_LAYERS, "weight_bytes": param_bytes(ccfg),
                     "checkpoint_bytes_on_disk": ckpt_bytes, "losses": rep_b.losses,
                     "resumed_from": rep_c.resumed_from, "steps_run": rep_c.steps_run,
                     "relaunch_losses": rep_c.losses,
                     "losses_equal": rep_c.losses == rep_b.losses[TRAIN_CKPT_EVERY:],
                     "grad_norms_equal":
                         rep_c.grad_norms == rep_b.grad_norms[TRAIN_CKPT_EVERY:],
                     "final_state_equal": restart_equal},
        "nondeterministic_ops": nondet, "profile_2_steps": prof, "card": smi}
    log(f"[train] tinyllama-1.1b {json.dumps(res)}")
    if not (rep.losses[-1] < rep.losses[0] and rep.skipped == 0
            and all(math.isfinite(v) for v in rep.losses)):
        fails.append(f"train tinyllama: losses {rep.losses}, skipped {rep.skipped}")
    rl = res["relaunch"]
    if not (rl["resumed_from"] == TRAIN_CKPT_EVERY and rl["losses_equal"]
            and rl["grad_norms_equal"] and restart_equal and rep_b.skipped == 0
            and rep_b.losses[-1] < rep_b.losses[0]):
        fails.append(f"train tinyllama: the relaunch from step {TRAIN_CKPT_EVERY} differs: "
                     f"{rl}; nondeterministic ops: {nondet}")
    off = res["offload"]
    if not (pinned_ok and off["losses_equal"] and off["grad_norms_equal"]
            and offload_equal and 0 < slow_bytes < total):
        fails.append(f"train tinyllama: the offloaded run differs: {off}")
    check_train_launches("train tinyllama", launches, expected_train_launches(0, 0, 0), fails)
    return launches


def train_moe_phase(torch, moe_full, smi, fails):
    """Full-width phi3.5-moe cut to ``TRAIN_MOE_LAYERS`` of its 32 layers:
    4 ``make_train_step`` steps at B=8, S=256 (finite losses, none
    skipped) with the MoE launches exact, then 2 traced steps."""
    import statistics

    from repro_torch import optim
    from repro_torch.data import DataConfig, make_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_train_step, profile_train_steps
    from repro_torch.models import nn
    from repro_torch.models.model import init_params, param_bytes

    pattern = moe_full.stacks[0][0]
    layers = TRAIN_MOE_LAYERS
    # the parameters, their gradients, m, v and the master copy
    if 5 * param_bytes(dataclasses.replace(moe_full, stacks=((pattern, layers),))) \
            > 75 * 2**30:
        layers = 1
    cfg = dataclasses.replace(moe_full, stacks=((pattern, layers),))
    log(f"[train] {MOE_ARCH}: depth cut from {moe_full.n_layers} to {layers} layers "
        f"({param_bytes(cfg) / 1e9:.2f} GB of float32 weights), widths as published")
    oc = optim.AdamWConfig()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    opt = optim.init(params, oc)
    step_fn = make_train_step(cfg, oc, optim.cosine_schedule(TRAIN_WARMUP, TRAIN_STEPS),
                              donate=True)
    batches = make_batches(DataConfig(**TRAIN_DATA), cfg)
    ops.reset_launch_counts()
    steps = 4
    params, opt, losses, _, secs, skipped = run_steps(step_fn, params, opt, batches, steps)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    prof = profile_train_steps(step_fn, params, opt, batches, "cuda",
                               str(ROOT / "build" / "profile" / "train_phi3.5-moe"))
    n_params = sum(t.numel() for t in nn.tree_leaves(params))
    mcfg = pattern[0].moe
    expert = sum(params["stacks"][0]["blocks"][0]["moe"][k].numel()
                 for k in ("wi_gate", "wi_up", "wo"))
    active = n_params - expert + expert * mcfg.top_k // mcfg.n_experts
    tokens = TRAIN_DATA["seq_len"] * TRAIN_DATA["global_batch"]
    med = statistics.median(secs)
    res = {"arch": MOE_ARCH, "layers": layers, "params": n_params, "active_params": active,
           "weight_bytes": param_bytes(cfg), "batch": TRAIN_DATA, "steps": steps,
           "losses": losses, "step_seconds": secs, "median_ms_per_step": med * 1e3,
           "tokens_per_s": tokens / med,
           "fp32_peak_share_active": 6.0 * active * tokens / med / PEAK_FLOPS["float32"],
           "peak_device_memory_GiB": peak / 2**30, "skipped": skipped,
           "launches": launches, "profile_2_steps": prof, "card": smi}
    log(f"[train] {MOE_ARCH} {json.dumps(res)}")
    if skipped or not all(math.isfinite(v) for v in losses):
        fails.append(f"train {MOE_ARCH}: losses {losses}, skipped {skipped}")
    check_train_launches(f"train {MOE_ARCH}", launches,
                         expected_train_launches(layers, steps, steps), fails)
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return launches, layers


def train_phase(torch, moe_full, smi, rows):
    """The [train] phase: the backward kernel, full-width MoE gradients,
    cuda == cpu training at smoke size, full-width tinyllama-1.1b with a
    relaunch and an offloaded run, phi3.5-moe cut to 2 layers.  Adds the
    ``moe_combine_bwd`` row and the route backward's time to ``rows``;
    returns each training run's launch counts."""
    fails: list = []
    flush = torch.ones(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    row = check_moe_combine_bwd(torch, gen, flush, fails)
    del flush
    route_row = next(r for r in rows if r["name"] == "moe_route")
    route_row["backward_T2048_ms"] = row.pop("route_backward_ms")
    route_row["backward_note"] = ("the route's backward, torch ops on (T, E) and two "
                                  "products, at phi3.5-moe's training shape")
    rows.append(row)
    moe_grads = check_moe_gradients(torch, moe_full, fails)
    row["full_width_gradients"] = moe_grads
    if fails:
        fail("; ".join(fails))
    launches = {}
    for arch in ("tinyllama-1.1b", MOE_ARCH) + FAMILIES:
        launches[f"train smoke/{arch}"] = train_smoke_phase(torch, arch, fails)
    if fails:
        fail("; ".join(fails))
    launches["train/tinyllama-1.1b"] = train_dense_phase(torch, smi, fails)
    if fails:
        fail("; ".join(fails))
    moe_launches, layers = train_moe_phase(torch, moe_full, smi, fails)
    launches[f"train/{MOE_ARCH} ({layers} layers)"] = moe_launches
    if fails:
        fail("; ".join(fails))
    return launches


def meminfo_bytes(key: str) -> int:
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith(key + ":"):
            return int(line.split()[1]) * 1024
    raise KeyError(key)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


if __name__ == "__main__":
    main()
