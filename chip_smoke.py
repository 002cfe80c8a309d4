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
   at each one's frame (458,752 to 4,718,592 B).  Times each kernel, its
   plain version and, where one exists, the one PyTorch call that
   computes the same function (the copies in phase 4; ``torch.mm`` of
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
   and tokens equal to the batched plane's on the same inputs up to a
   logged near-tie (top-2 logit gap below ``NEAR_TIE``).  Then the same
   two planes serve full-width gemma3-4b on prompts of 1100 tokens, past
   its local layers' window of 1024, with exact attention, 48 fast and
   128 slow frames (2 requests × 16 tokens): the first serve run whose
   window masks, with tokens equal between the planes up to a logged
   near-tie and placement equal to ``WINDOWED_PLACEMENT``.  Last, with
   ``TIERSAN_LEVEL=full`` and ``TIERSAN_PLAN_CHECK=1``, scripted
   smoke-size lifecycles run on ``cuda`` and on ``cpu``: all seven archs
   on both planes, tinyllama under each baseline, and a two-tenant QoS
   lifecycle that must shed a batch request; tokens, stats (with
   ``stats()["qos"]``), VmStat, tiers and page types must be equal.
4. **Copies** — ``page_gather`` and ``page_scatter`` timed at each of the
   seven serve runs' median flush (pairs × both stores, at its frame) and at 64
   live frames of one store, beside their plain versions, the library
   calls (``index_select`` / ``index_copy_`` once per store) and the
   bytes bound; and one gather then scatter, as a flush runs them.

Prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power
line, and last ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero before the result lines; there is no CPU fallback.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
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
              pad_tail=1, distinct=False):
    """Random position-mode inputs over an (F, L, Hkv, P, D) store: the
    last ``pad_tail`` entries of each lane are pad entries on the trash
    frame; ``distinct`` gives every entry its own frame."""
    from repro_torch.kernels.paged_attention import PAD_PAGE_POS

    dev = "cuda"
    store_k = torch.randn((F, L, Hkv, P, D), generator=gen, device=dev).to(dtype)
    store_v = torch.randn((F, L, Hkv, P, D), generator=gen, device=dev).to(dtype)
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
    ``families``: name → config of each family served in phase 3, checked
    and timed at its prefill (S=47, its first layer's window);
    ``windowed``: ``(name, cfg, S)`` of the windowed run's prefill, with
    and without the window."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

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
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs an NVIDIA card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
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
    # the copy kernels at each serve path's frame; timed after phase 3, at
    # the flush sizes the serve runs give them
    moe_frame = frame_shape(moe_cfg, ecfg)
    frames = {"tinyllama-1.1b": frame_shape(cfg, ecfg), MOE_ARCH: moe_frame}
    frames.update({name: frame_shape(c, ecfg) for name, c in fam_cfgs.items()})
    copy_checks = check_page_migrate(torch, gen, F, frames["tinyllama-1.1b"], fails)
    for name in list(frames)[1:]:
        copy_checks += check_page_migrate(torch, gen, F, frames[name], fails, sweeps=False)
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

    # ---------------- phase 4: the copies at the serve runs' flushes --- #
    flush = torch.ones(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
    copy_times = {}
    for name in frames:
        med = median_pairs(flush_pairs[name])
        copy_times[name] = time_page_migrate(torch, gen, F, frames[name], med, flush)
        log(f"[kernels] copies at {name}'s median flush of {med} pairs: "
            f"{json.dumps(copy_times[name])}")
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
        })
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
    from repro_torch.kernels.page_migrate import MAX_PAIRS
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
    expected = {"paged_attention": L * steps, "flash_attention": L * requests,
                "router_topk": 0, "moe_route": routed, "moe_dispatch": routed,
                "moe_combine": routed}
    for kname, n in expected.items():
        if launches[kname] != n:
            fail(f"{name}: {kname} launched {launches[kname]} times, expected {n}")
    # the copies: one gather and one scatter a flush (a launch per
    # MAX_PAIRS pairs), and the cache's one-frame prewarm
    kv = res["engine"].kv
    copies = expected_copies(kv, MAX_PAIRS)
    for kname in ("page_gather", "page_scatter"):
        if launches[kname] != copies:
            fail(f"{name}: {kname} launched {launches[kname]} times, expected "
                 f"{copies} ({kv.flushes} flushes + the prewarm)")
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
    copies = expected_copies(kv, MAX_PAIRS)
    expected = {"paged_attention": L * steps, "flash_attention": L * requests,
                "router_topk": 0, "moe_route": 0, "moe_dispatch": 0, "moe_combine": 0,
                "page_gather": copies, "page_scatter": copies}
    for kname, n in expected.items():
        if launches[kname] != n:
            fail(f"{name}: {kname} launched {launches[kname]} times, expected {n}")
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
    batched plane's, or differ first where its top-2 logit gap is below
    ``NEAR_TIE`` (a near-tie, logged as such).  Both planes must place
    pages alike, and as ``placement`` where one is given."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.page_migrate import MAX_PAIRS
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
        copies = expected_copies(kv, MAX_PAIRS)
        expected = {"paged_attention": L * steps if staged else 0,
                    "flash_attention": L * requests, "router_topk": 0, "moe_route": 0,
                    "moe_dispatch": 0, "moe_combine": 0,
                    "page_gather": copies, "page_scatter": copies}
        for kname, n in expected.items():
            if launches[kname] != n:
                fail(f"{name} reference phase, {plane} plane: {kname} launched "
                     f"{launches[kname]} times, expected {n}")
        runs[plane] = {"tokens": res["tokens"], "ms_per_step": res["ms_per_step"],
                       "steps": steps, "stats": res["stats"], "launches": launches}
        res["engine"].kv.pool.check_invariants()
        del res, kv
    ref, bat = runs["reference"], runs["batched"]
    rids = sorted(ref["tokens"])
    first = min(((i, rid) for rid in rids
                 for i, (a, b) in enumerate(zip(ref["tokens"][rid], bat["tokens"][rid]))
                 if a != b), default=None)
    verdict = "equal"
    if first is not None:
        step, rid = first
        rows = [row for s, row in recorded if s == step]
        top2 = torch.topk(rows[rids.index(rid)].float(), 2).values
        gap = float(top2[0] - top2[1])
        log(f"[reference] tokens first differ at decode step {step}, request "
            f"{rid}: reference {ref['tokens'][rid][step]} batched "
            f"{bat['tokens'][rid][step]}, reference top-2 logit gap {gap}")
        if not gap < NEAR_TIE:
            fail(f"{name}: reference plane tokens differ from the batched plane's at step "
                 f"{step} (request {rid}) with a top-2 logit gap of {gap} >= {NEAR_TIE}")
        verdict = f"near-tie at step {step}, gap {gap}"
    elif any(len(ref["tokens"][r]) != max_new for r in rids):
        fail(f"{name} reference phase: malformed tokens")
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
