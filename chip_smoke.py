#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel,
into ``build/``) and runs these phases:

1. **Device** — the card's name and power limit, torch and CUDA
   versions; TF32 off for matmul and cuDNN (float32 throughout).
2. **Kernels** — each of the five kernels against its plain PyTorch
   version on the card: ``paged_attention`` at the decode shapes of
   tinyllama-1.1b (H=32, Hkv=4, D=64) and phi3.5-moe (H=32, Hkv=8,
   D=128), P=16, B=MP=8, over strided ``store[:, li]`` views; gather and
   scatter of 64 frames with trash-frame padding, exact, at both serve
   paths' frames (tinyllama (22, 4, 16, 64), phi3.5-moe (8, 8, 16,
   128)); ``router_topk`` at the MoE serve
   shapes (T=8 decode, T=47 prefill, E=16, k=2), rows of exact ties and
   T=4096, E=64, k=6; one full-width phi3.5-moe MoE layer on the card
   against the CPU at its decode and prefill shapes, where experts
   overflow and drop assignments; no launch counted for empty inputs;
   ``flash_attention`` at the two prefill shapes (S=47, causal, through
   the engine's transposed views) and S=512, D=64; plus the small sweeps
   of ``tests/test_kernels.py``.  Times each kernel, its plain version
   and, where one exists, the one PyTorch call that computes the same
   function.
3. **Serve** — full-width tinyllama-1.1b, then full-width phi3.5-moe
   cut to 8 of its 32 layers (42.7 GB of float32 weights), each with
   seeded random weights through ``ServingEngine`` on ``cuda``: 8
   requests, prompt 48, 32 new tokens each, with demotions and
   promotions.  Launch counts are set to 0 before each run and read
   after it; each kernel of the path must have launched exactly as
   often as the path calls it.  Then 8 decode steps of a fresh batch
   are traced with ``torch.profiler`` (device busy time, idle share and
   top device ops per step; trace in ``build/profile/<arch>/``).  Last,
   each smoke-size config runs one scripted lifecycle on ``cuda`` and
   on ``cpu``; tokens, stats, VmStat, tiers and page types must be
   equal.

Prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power
line, and last ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero before the result lines; there is no CPU fallback.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS = 8  # of 32: 42.7 GB of float32 weights on an 80 GB card
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:18


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


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------- #
def attn_case(torch, gen, B, H, Hkv, P, MP, D, F, L, dtype, window, pad_lanes):
    """Random position-mode inputs over an (F, L, Hkv, P, D) store."""
    from repro_torch.kernels.paged_attention import PAD_PAGE_POS

    dev = "cuda"
    store_k = torch.randn((F, L, Hkv, P, D), generator=gen, device=dev).to(dtype)
    store_v = torch.randn((F, L, Hkv, P, D), generator=gen, device=dev).to(dtype)
    q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype)
    trash = F - 1
    bt = torch.randint(0, F - 1, (B, MP), generator=gen, device=dev).to(torch.int32)
    ps = (torch.arange(MP, device=dev, dtype=torch.int32) * P).expand(B, MP).clone()
    q_pos = torch.full((B,), MP * P - 3, dtype=torch.int32, device=dev)
    ps[:, MP - 1] = PAD_PAGE_POS  # one pad entry per lane
    bt[:, MP - 1] = trash
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


def check_paged_attention(torch, gen, F, L, moe_L, flush, fails):
    from repro_torch.kernels import ops
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

    main = None
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for window in (None, 40):
            case = attn_case(torch, gen, 8, 32, 4, 16, 8, 64, F, L, dtype,
                             window, pad_lanes=2)
            run(f"main B=8 MP=8 F={F} L={L} window={window}", case, dtype_name,
                exact_zero_rows=2)
            if dtype_name == "float32" and window is None:
                main = case
    # phi3.5-moe's decode shape: Hkv=8, G=4, D=128 over its 8-layer store
    moe = attn_case(torch, gen, 8, 32, 8, 16, 8, 128, F, moe_L, torch.float32,
                    None, pad_lanes=2)
    run(f"phi3.5-moe decode B=8 MP=8 Hkv=8 D=128 F={F} L={moe_L}", moe, "float32",
        exact_zero_rows=2)
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
        kw = dict(page_pos=case["page_pos"], q_pos=case["q_pos"])
        nbytes, flops = attn_work(torch, case)
        b_ms, b_by = bound(nbytes, flops)
        return dict(
            kernel_ms=time_ms(torch, lambda: pa.paged_attention(*args, **kw), flush),
            plain_ms=time_ms(torch, lambda: pa.paged_attention_plain(*args, **kw), flush),
            bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes, bound_flops=flops)

    t = timed(main)
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
        "phi3_5_moe_decode": dict(
            timed(moe), shape="q (8, 32, 128) f32, store[:, li] of "
            f"(F={F}, L={moe_L}, 8, 16, 128), block table (8, 8), 2 pad lanes"),
        "checks": len(checks),
    }


def frame_shape(cfg, ecfg):
    """One frame of the engine's KV store: ``(L, Hkv, P, D)``."""
    a = cfg.all_specs()[0].attn
    return (cfg.n_layers, a.n_kv_heads, ecfg.page_size, a.head_dim)


def check_page_migrate(torch, gen, F, frame, flush, fails, sweeps=True):
    """Gather and scatter of 64 frames of ``frame = (L, Hkv, P, D)`` over a
    store of ``F`` frames, against ``index_select``/``index_copy_``
    (exact), then timed; ``sweeps`` adds the small round trips of
    ``tests/test_kernels.py``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import page_migrate as pm

    N, real = 64, 16
    trash = F - 1
    store = torch.randn((F,) + tuple(frame), generator=gen, device="cuda")
    perm = torch.randperm(F - 1, generator=gen, device="cuda")
    src = torch.full((N,), trash, dtype=torch.int32, device="cuda")
    dst = src.clone()
    src[:real] = perm[:real].to(torch.int32)
    dst[:real] = perm[real:2 * real].to(torch.int32)
    frame_bytes = store[0].numel() * store.element_size()

    g_kernel = ops.page_gather(store, src, impl="kernel")
    torch.cuda.synchronize()
    g_plain = ops.page_gather(store, src, impl="ref")
    gather_err = (g_kernel - g_plain).abs().max().item()
    if not torch.equal(g_kernel, g_plain):
        fails.append(f"page_gather at frame {frame} differs from index_select: "
                     f"{gather_err}")
    s_kernel = ops.page_scatter(store.clone(), dst, g_kernel, impl="kernel")
    torch.cuda.synchronize()
    s_plain = ops.page_scatter(store.clone(), dst, g_plain, impl="ref")
    scatter_err = (s_kernel - s_plain).abs().max().item()
    if not torch.equal(s_kernel, s_plain):
        fails.append(f"page_scatter at frame {frame} differs from index_copy_: "
                     f"{scatter_err}")
    # small sweeps of tests/test_kernels.py:123-141
    for n, f, seed in [(1, 8, 0), (4, 16, 7), (8, 24, 42), (5, 23, 31)] if sweeps else []:
        g = torch.Generator(device="cuda").manual_seed(seed)
        s = torch.randn((f, 2, 4, 8), generator=g, device="cuda")
        idx = torch.randperm(f, generator=g, device="cuda")[:n].to(torch.int32)
        out = ops.page_gather(s, idx, impl="kernel")
        back = ops.page_scatter(torch.zeros_like(s), idx, out, impl="kernel")
        torch.cuda.synchronize()
        want = torch.zeros_like(s).index_copy_(0, idx.long(), s.index_select(0, idx.long()))
        if not (torch.equal(out, s.index_select(0, idx.long())) and torch.equal(back, want)):
            fails.append(f"page_gather/page_scatter round trip n={n} f={f}")

    uniq_src = len(set(src.tolist()))
    uniq_dst = len(set(dst.tolist()))
    work, scratch = store.clone(), store.clone()
    src_l, dst_l = src.long(), dst.long()
    rows = []
    for name, kernel, plain, library, nbytes, line in (
        ("page_gather",
         lambda: pm.page_gather(store, src),
         lambda: pm.page_gather_plain(store, src),
         lambda: store.index_select(0, src_l),
         (uniq_src + N) * frame_bytes + N * 4,
         "src/repro/kernels/page_migrate.py:47"),
        ("page_scatter",
         lambda: pm.page_scatter(work, dst, g_kernel),
         lambda: pm.page_scatter_plain(scratch, dst, g_kernel),
         lambda: scratch.index_copy_(0, dst_l, g_kernel),
         2 * uniq_dst * frame_bytes + N * 4,
         "src/repro/kernels/page_migrate.py:79"),
    ):
        b_ms, b_by = bound(nbytes, 0.0)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/page_migrate.cu",
            "replaces": line,
            "shape": f"N={N} frames ({real} real + {N - real} trash padding) of "
                     f"(L, Hkv, P, D) = {tuple(frame)} f32, {frame_bytes} B each, "
                     f"store F={F}",
            "max_abs_err": gather_err if name == "page_gather" else scatter_err,
            "tolerance": 0.0,
            "kernel_ms": time_ms(torch, kernel, flush),
            "plain_ms": time_ms(torch, plain, flush),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
            "bound_ms_padded_width": 2 * N * frame_bytes / HBM_BYTES_PER_S * 1e3,
            "library_ms": time_ms(torch, library, flush),
        })
    return rows


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
    ops.paged_attention(torch.empty((0, 4, 64), device=dev),
                        torch.empty((3, 2, 16, 64), device=dev),
                        torch.empty((3, 2, 16, 64), device=dev),
                        torch.empty((0, 2), dtype=torch.int32, device=dev),
                        torch.empty((0,), dtype=torch.int32, device=dev), impl="kernel")
    store = torch.zeros((3, 2, 16, 64), device=dev)
    none = torch.empty((0,), dtype=torch.int32, device=dev)
    pages = ops.page_gather(store, none, impl="kernel")
    ops.page_scatter(store, none, pages, impl="kernel")
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


def check_flash_attention(torch, gen, flush, fails):
    """Kernel against plain version within ``TOL``; the serve shapes go
    through the engine's (1, S, H, D) → (1, H, S, D) transposed views."""
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

    def timed(q, k, v):
        nbytes, flops = flash_work(torch, q, k, True, None)
        b_ms, b_by = bound(nbytes, flops)
        lib = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        want = fa.flash_attention_plain(q, k, v)
        return dict(
            kernel_ms=time_ms(torch, lambda: fa.flash_attention(q, k, v), flush),
            plain_ms=time_ms(torch, lambda: fa.flash_attention_plain(q, k, v), flush),
            bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes, bound_flops=flops,
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), flush),
            library_max_abs_err=(lib - want).abs().max().item())

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
    from repro_torch.launch.serve import strict_fp32
    from repro_torch.models.model import param_bytes
    from repro_torch.serving import EngineConfig

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
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # the serving configuration of phase 3 (and the kernel shapes it gives)
    cfg = get_config("tinyllama-1.1b")
    moe_full = get_config(MOE_ARCH)
    moe_cfg = dataclasses.replace(moe_full, stacks=((moe_full.stacks[0][0], MOE_LAYERS),))
    ecfg = EngineConfig(page_size=16, num_fast=24, num_slow=64, topk_pages=4,
                        max_seqs=8, tpp=TppConfig(demote_budget=64, promote_budget=32))
    F = ecfg.num_fast + ecfg.num_slow + 1

    # ---------------- phase 2: kernels -------------------------------- #
    fails: list = []
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flush = torch.ones(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
    rows = [check_paged_attention(torch, gen, F, cfg.n_layers, MOE_LAYERS, flush, fails)]
    # the copy kernels at each serve path's frame, the phi3.5 rows beside
    # tinyllama's as paged_attention's phi3_5_moe_decode is
    moe_frame = frame_shape(moe_cfg, ecfg)
    migrate = check_page_migrate(torch, gen, F, frame_shape(cfg, ecfg), flush, fails)
    for row, moe_row in zip(migrate, check_page_migrate(
            torch, gen, F, moe_frame, flush, fails, sweeps=False)):
        row["phi3_5_moe_serve"] = {k: moe_row[k] for k in (
            "shape", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "bound_bytes", "bound_ms_padded_width", "library_ms")}
    rows += migrate
    rows.append(check_router_topk(torch, gen, flush, fails))
    rows[-1]["moe_fwd_cuda_vs_cpu"] = check_moe_fwd(torch, moe_cfg, fails)
    check_empty_inputs(torch, fails)
    rows.append(check_flash_attention(torch, gen, flush, fails))
    del flush
    for r in rows:
        log(f"[kernels] {r['name']}: max_abs_err {r['max_abs_err']} "
            f"(tol {r['tolerance']}) kernel {r['kernel_ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']}) library {r['library_ms']}")
    if fails:
        fail("; ".join(fails))

    # ---------------- phase 3: serve ---------------------------------- #
    launches_by_path = {}
    for name, c in (("tinyllama-1.1b", cfg), (MOE_ARCH, moe_cfg)):
        if c is moe_cfg:
            log(f"[serve] {MOE_ARCH}: depth cut from {moe_full.n_layers} to "
                f"{moe_cfg.n_layers} layers ({param_bytes(moe_cfg) / 1e9:.1f} GB of "
                f"float32 weights; all {moe_full.n_layers} would be "
                f"{param_bytes(moe_full) / 1e9:.1f} GB), widths as published")
        launches_by_path[name] = serve_phase(torch, name, c, ecfg)

    # smoke configs: one lifecycle on cuda and on cpu must agree exactly
    for arch in ("tinyllama-1.1b", MOE_ARCH):
        smoke_lifecycle(torch, arch)

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
    from repro_torch.launch.serve import profile_decode, serve
    from repro_torch.models.model import init_params

    requests, prompt_len, max_new = 8, 48, 32
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
        "peak_device_memory_bytes": peak, "stats": stats, "launches": launches,
    }
    log(f"[serve] {name}: {res['n_tokens']} tokens in {res['steps']} decode steps: "
        f"{res['tokens_per_s']:.2f} tok/s, {res['ms_per_step']:.3f} ms/step, "
        f"prefill of {requests} prompts {res['prefill_s']:.3f} s, peak device "
        f"memory {peak / 2**30:.2f} GiB")
    log(f"[serve] summary {json.dumps(summary)}")
    L, steps = cfg.n_layers, res["steps"]
    moe = any(s.moe is not None for s in cfg.all_specs())
    expected = {"paged_attention": L * steps, "flash_attention": L * requests,
                "router_topk": L * (steps + requests) if moe else 0}
    for kname, n in expected.items():
        if launches[kname] != n:
            fail(f"{name}: {kname} launched {launches[kname]} times, expected {n}")
    for kname in ("page_gather", "page_scatter"):
        if launches[kname] <= 0:
            fail(f"{name}: the serve phase never launched {kname}")
    if stats["demoted"] <= 0 or stats["promoted"] <= 0:
        fail(f"{name}: serve phase did not tier: {stats}")
    toks = [t for out in res["tokens"].values() for t in out]
    if len(toks) != requests * max_new or not all(0 <= t < cfg.vocab for t in toks):
        fail(f"{name}: serve phase produced malformed tokens")
    res["engine"].kv.pool.check_invariants()
    # where a decode step's time goes: 8 traced steps of a fresh batch
    prof = profile_decode(res["engine"], cfg.vocab, requests, prompt_len, 8,
                          str(ROOT / "build" / "profile" / name))
    log(f"[serve] {name} profile {json.dumps(prof)}")
    del res, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def smoke_lifecycle(torch, arch):
    """The smoke config's scripted lifecycle on cuda and on cpu: every
    observable field must be equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import TppConfig
    from repro_torch.launch.serve import lifecycle_trace
    from repro_torch.models.model import init_params, tree_map
    from repro_torch.serving import EngineConfig, ServingEngine

    scfg = get_smoke_config(arch)
    sparams = init_params(scfg, torch.Generator().manual_seed(0), device="cpu")
    secfg = EngineConfig(page_size=4, num_fast=10, num_slow=64, recent_pages=1,
                         topk_pages=2, tpp=TppConfig(demote_budget=16, promote_budget=8))
    traces = {}
    devices = ("cuda", "cpu")
    for dev in devices:
        p = sparams if dev == "cpu" else tree_map(lambda t: t.to("cuda"), sparams)
        traces[dev] = lifecycle_trace(ServingEngine(scfg, p, secfg, device=dev),
                                      scfg.vocab)
    card, host = (traces[d] for d in devices)
    for field in ("tokens", "stats", "finished_out", "tiers", "types", "vmstat"):
        a, b = card[field], host[field]
        if a != b:
            first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None) \
                if isinstance(a, list) else None
            fail(f"{arch} smoke lifecycle cuda != cpu in {field!r}"
                 + (f" at index {first}: {a[first]} vs {b[first]}" if first is not None
                    else f": {a} vs {b}"))
    if card["vmstat"]["pgdemote_total"] <= 0:
        fail(f"{arch} smoke lifecycle did not demote")
    log(f"[serve] {arch} smoke lifecycle cuda == cpu: "
        f"{sum(len(t) for t in card['tokens'])} tokens, "
        f"demoted {card['vmstat']['pgdemote_total']}, "
        f"promoted {card['vmstat']['pgpromote_total']}")


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
