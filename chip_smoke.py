#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel,
into ``build/``) and runs three phases:

1. **Device** — the card's name and power limit, torch and CUDA
   versions; TF32 off for matmul and cuDNN (float32 throughout).
2. **Kernels** — each kernel against its plain PyTorch version on the
   card, at the serving path's shapes (tinyllama-1.1b: H=32, Hkv=4,
   D=64, P=16, B=MP=8 over the strided ``store[:, li]`` view; gather and
   scatter of 64 full-width frames with trash-frame padding) and at the
   small sweeps of ``tests/test_kernels.py``; times each kernel, its
   plain version and, where one exists, the one PyTorch call that
   computes the same function.
3. **Serve** — full-width tinyllama-1.1b with seeded random weights
   through ``ServingEngine`` on ``cuda``: 8 requests, prompt 48, 32 new
   tokens each, with demotions and promotions; every kernel's launch
   count must rise.  Then the smoke-size config runs one scripted
   lifecycle on ``cuda`` and on ``cpu``; tokens and VmStat must be equal.

Prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power
line, and last ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero before the result lines; there is no CPU fallback.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
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
def time_ms(torch, fn, flush, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time of one call with a cold L2 (the decode step
    streams ~46 MB of FFN weights between attention layers, so the store
    is cold when the kernel runs).

    Before each call the card reads the whole ``flush`` buffer (256 MB, a
    sum into one element), which leaves L2 full of clean lines: writing
    the buffer instead would leave dirty lines whose write-back runs
    inside the timed call.  The read keeps the card busy for some 80 µs
    while the host queues the call, so the start event does not wait on
    the host's launch overhead.
    """
    sink = torch.empty((), dtype=flush.dtype, device=flush.device)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        torch.sum(flush, dim=0, out=sink)
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


def check_paged_attention(torch, gen, F, L, flush, fails):
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

    kernel_ms = time_ms(torch, lambda: pa.paged_attention(
        main["q"], main["k_pages"], main["v_pages"], main["block_table"],
        page_pos=main["page_pos"], q_pos=main["q_pos"]), flush)
    plain_ms = time_ms(torch, lambda: pa.paged_attention_plain(
        main["q"], main["k_pages"], main["v_pages"], main["block_table"],
        page_pos=main["page_pos"], q_pos=main["q_pos"]), flush)
    nbytes, flops = attn_work(torch, main)
    b_ms, b_by = bound(nbytes, flops)
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
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "bound_bytes": nbytes, "bound_flops": flops,
        "library_ms": None,
        "checks": len(checks),
    }


def check_page_migrate(torch, gen, F, L, flush, fails):
    from repro_torch.kernels import ops
    from repro_torch.kernels import page_migrate as pm

    N, real = 64, 16
    trash = F - 1
    store = torch.randn((F, L, 4, 16, 64), generator=gen, device="cuda")
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
        fails.append(f"page_gather differs from index_select: {gather_err}")
    s_kernel = ops.page_scatter(store.clone(), dst, g_kernel, impl="kernel")
    torch.cuda.synchronize()
    s_plain = ops.page_scatter(store.clone(), dst, g_plain, impl="ref")
    scatter_err = (s_kernel - s_plain).abs().max().item()
    if not torch.equal(s_kernel, s_plain):
        fails.append(f"page_scatter differs from index_copy_: {scatter_err}")
    # small sweeps of tests/test_kernels.py:123-141
    for n, f, seed in [(1, 8, 0), (4, 16, 7), (8, 24, 42), (5, 23, 31)]:
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
                     f"(L={L}, 4, 16, 64) f32, {frame_bytes} B each, store F={F}",
            "max_abs_err": gather_err if name == "page_gather" else scatter_err,
            "tolerance": 0.0,
            "kernel_ms": time_ms(torch, kernel, flush),
            "plain_ms": time_ms(torch, plain, flush),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
            "bound_ms_padded_width": 2 * N * frame_bytes / HBM_BYTES_PER_S * 1e3,
            "library_ms": time_ms(torch, library, flush),
        })
    return rows


# --------------------------------------------------------------------- #
def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs an NVIDIA card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import TppConfig
    from repro_torch.kernels import build, ops
    from repro_torch.launch.serve import lifecycle_trace, serve, strict_fp32
    from repro_torch.models.model import init_params, tree_map
    from repro_torch.serving import EngineConfig, ServingEngine

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
    ecfg = EngineConfig(page_size=16, num_fast=24, num_slow=64, topk_pages=4,
                        max_seqs=8, tpp=TppConfig(demote_budget=64, promote_budget=32))
    F = ecfg.num_fast + ecfg.num_slow + 1
    L = cfg.n_layers

    # ---------------- phase 2: kernels -------------------------------- #
    fails: list = []
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flush = torch.ones(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
    rows = [check_paged_attention(torch, gen, F, L, flush, fails)]
    rows += check_page_migrate(torch, gen, F, L, flush, fails)
    del flush
    for r in rows:
        log(f"[kernels] {r['name']}: max_abs_err {r['max_abs_err']} "
            f"(tol {r['tolerance']}) kernel {r['kernel_ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) library {r['library_ms']}")
    if fails:
        fail("; ".join(fails))

    # ---------------- phase 3: serve ---------------------------------- #
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] tinyllama-1.1b full width: {L} layers, d={cfg.d_model}, "
        f"params {sum(t.numel() for t in _leaves(params)) / 1e9:.3f} G float32, "
        f"built in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve(cfg, params, ecfg, requests=8, prompt_len=48, max_new=32,
                seed=0, device="cuda")
    launches = ops.launch_counts()
    stats = res["stats"]
    log(f"[serve] {res['n_tokens']} tokens in {res['steps']} decode steps: "
        f"{res['tokens_per_s']:.2f} tok/s, {res['ms_per_step']:.3f} ms/step, "
        f"prefill of 8 prompts {res['prefill_s']:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[serve] stats {json.dumps(stats)}")
    log(f"[serve] launches {json.dumps(launches)} "
        f"(paged_attention per step {launches['paged_attention'] / res['steps']})")
    for name, n in launches.items():
        if n <= 0:
            fail(f"the serve phase never launched {name}")
    if launches["paged_attention"] != L * res["steps"]:
        fail(f"paged_attention launched {launches['paged_attention']} times, "
             f"expected {L} per step")
    if stats["demoted"] <= 0 or stats["promoted"] <= 0:
        fail(f"serve phase did not tier: {stats}")
    toks = [t for out in res["tokens"].values() for t in out]
    if len(toks) != 8 * 32 or not all(0 <= t < cfg.vocab for t in toks):
        fail("serve phase produced malformed tokens")
    res["engine"].kv.pool.check_invariants()
    del res, params
    torch.cuda.empty_cache()

    # smoke config: one lifecycle on cuda and on cpu must agree exactly
    scfg = get_smoke_config("tinyllama-1.1b")
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
            fail(f"smoke lifecycle cuda != cpu in {field!r}"
                 + (f" at index {first}: {a[first]} vs {b[first]}" if first is not None
                    else f": {a} vs {b}"))
    log(f"[serve] smoke lifecycle cuda == cpu: "
        f"{sum(len(t) for t in card['tokens'])} tokens, "
        f"demoted {card['vmstat']['pgdemote_total']}, "
        f"promoted {card['vmstat']['pgpromote_total']}")

    for r in rows:
        r["launches"] = launches[r["name"]]
        r["ms"] = r["kernel_ms"]  # the same time under the kernels line's short key
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


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
