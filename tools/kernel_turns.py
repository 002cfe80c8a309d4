"""Time ``flash_attention``'s bfloat16 path and ``moe_route`` against an
earlier commit's build, in turns, on one NVIDIA card, and split the
route's time between its product and the rest.

Run from the repository root, with an earlier commit's kernels unpacked
into a directory that ``.gitignore`` lists::

    mkdir -p build/parent
    git archive <commit> src/repro_torch/kernels | tar -x -C build/parent
    python3 tools/kernel_turns.py --parent build/parent > chiprun_out/kernel_turns.log

Builds, each from its own ``csrc/*.cu`` and called through its own
wrapper module (the parent's ``flash_attention.py`` and
``router_topk.py`` loaded from ``--parent``, bound to the parent's
libraries):

* ``change``: this checkout's kernels;
* ``parent``: the ``--parent`` kernels;
* ``change_phase1`` and ``parent_phase1``: ``router_topk.cu`` of each,
  cut after phase 1 (the router product's partials are written, then the
  block returns; no counter, no top-k, no slots, no second launch), so
  that the route's time splits into the product and the rest.

Every case runs in turns, ``parent, change, change, parent`` (the phase-1
builds beside their own), each time a cold-L2 mean of one call
(``chip_smoke.time_ms``).  The library call (SDPA, ``torch.mm``) and the
plain version are timed before and after the turns.  Before timing,
every build is held to the plain version: flash within
``chip_smoke.TOL`` (and its share of outputs that round away from the
plain version printed), the route's experts, slots, ``src`` and counts
exactly equal to the plain routing on the build's own logits.  Beside
each flash case: its bound (``chip_smoke.flash_work``, 4·D flops a
visible pair), the floor of a kernel that issues p·V in three bf16 parts
(8·D a pair at 989 TFLOP/s) and the TFLOP/s each time issues at 8·D.

Prints one ``[flash]`` or ``[route]`` line a case, the ``nvidia-smi``
name and power limit, and last one JSON object ``{"kernel_turns":
{...}}`` with every turn (also written to
``chiprun_out/kernel_turns.json``).  Exits non-zero if a build fails a
check.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = Path("src") / "repro_torch" / "kernels"
OUT = ROOT / "build" / "kernel_turns"
TURNS = ("parent", "change", "change", "parent")

# router_topk.cu cut after phase 1: the line after the partial's write
# becomes a return, and the second launch (where a source has one) is
# skipped; (text, replacement) pairs, each found exactly once
PHASE1 = ("  // After the barrier one thread counts the chunk with release semantics\n",
          "  return;  // phase 1 only\n")
PHASE1_NO_PLACE = ("  if (NT == 1) return static_cast<int>(cudaGetLastError());\n",
                   "  return static_cast<int>(cudaGetLastError());\n")

# name: (B, H, Hkv, S, D, views) of the bfloat16 flash cases
FLASH = {"serve prefill (1, 32, 47, 128) Hkv=8, views": (1, 32, 8, 47, 128, True),
         "kernel_bench (1, 8, 512, 64) Hkv=2": (1, 8, 2, 512, 64, False),
         "phi3.5 heads (1, 32, 2048, 128) Hkv=8": (1, 32, 8, 2048, 128, False),
         "long serve prefill (1, 32, 2047, 128) Hkv=8, views": (1, 32, 8, 2047, 128, True)}
# name: (T, d, E, k, C) of the route cases; the phase split where marked
ROUTE = {"phi3.5-moe decode T=8": (8, 4096, 16, 2, 1),
         "phi3.5-moe prefill T=47": (47, 4096, 16, 2, 7),
         "phi3.5-moe train T=2048": (2048, 4096, 16, 2, 320),
         "deepseek-v2-lite decode T=2": (2, 2048, 64, 6, 1),
         "deepseek-v2-lite decode T=8": (8, 2048, 64, 6, 1),
         "deepseek-v2-lite train T=2048": (2048, 2048, 64, 6, 240),
         "deepseek-v2-lite T=4096": (4096, 2048, 64, 6, 480),
         "deepseek-v2-lite T=16448": (16448, 2048, 64, 6, 1927),
         "deepseek-v2-lite T=32768": (32768, 2048, 64, 6, 3840)}
SPLIT = ("phi3.5-moe train T=2048", "deepseek-v2-lite train T=2048",
         "deepseek-v2-lite T=4096", "deepseek-v2-lite T=32768")


def variant(src: Path, name: str) -> Path:
    """``src`` cut after phase 1, written to ``OUT/<name>.cu``."""
    text = src.read_text()
    subs = [PHASE1] + ([PHASE1_NO_PLACE] if "moe_route_kernel_place" in text else [])
    for a, b in subs:
        if text.count(a) != 1:
            raise SystemExit(f"kernel_turns: {name}: {a!r} found {text.count(a)} times")
        text = text.replace(a, b)
    out = OUT / f"{name}.cu"
    out.write_text(text)
    return out


def start_builds(build, parent: Path):
    """One ``nvcc`` a source, all started together → ``{name: (proc, .so)}``."""
    OUT.mkdir(parents=True, exist_ok=True)
    csrc, pcsrc = ROOT / KERNELS / "csrc", parent / KERNELS / "csrc"
    srcs = {"parent_flash_attention": (pcsrc / "flash_attention.cu", pcsrc),
            "parent_router_topk": (pcsrc / "router_topk.cu", pcsrc),
            "parent_phase1_router_topk": (variant(pcsrc / "router_topk.cu", "parent_phase1"),
                                          pcsrc),
            "change_phase1_router_topk": (variant(csrc / "router_topk.cu", "change_phase1"),
                                          csrc)}
    procs = {}
    for name, (src, inc) in srcs.items():
        so = OUT / f"{name}.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(inc), "-o", str(so), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    return procs


def module_over(build, path: Path, name: str, lib_path: Path):
    """The wrapper module at ``path`` loaded as ``name``, its ``build``
    replaced by one that hands it the library at ``lib_path``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # a dataclass of the module looks its module up
    spec.loader.exec_module(mod)
    lib = ctypes.CDLL(str(lib_path))
    lib.tpp_error_string.argtypes = [ctypes.c_int]
    lib.tpp_error_string.restype = ctypes.c_char_p
    bound = []

    def library(_name, bind):
        if not bound:
            bind(lib)
            bound.append(lib)
        return lib

    mod.build = types.SimpleNamespace(library=library, counters=build.counters,
                                      sm_count=build.sm_count, check=build.check)
    return mod


def in_turns(builds, measure, order=TURNS):
    """``measure(module)`` under each build in ``order`` → ``{build: [..]}``."""
    out = {}
    for name in order:
        out.setdefault(name, []).append(measure(builds[name]))
    return out


def flash_phase(torch, cs, builds, flush, fails):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(27)
    tol = cs.TOL["bfloat16"]
    out = {}
    for name, (B, H, Hkv, S, D, views) in FLASH.items():
        def rand(h):
            if views:
                return torch.randn((B, S, h, D), generator=gen, device="cuda").to(
                    torch.bfloat16).transpose(1, 2)
            return torch.randn((B, h, S, D), generator=gen, device="cuda").to(torch.bfloat16)

        q, k, v = rand(H), rand(Hkv), rand(Hkv)
        plain = builds["change"].flash_attention_plain(q, k, v)
        want = plain.float()
        res = {"plan": vars(builds["change"].wgmma_plan(
            B, H, S, S, D, builds["change"].build.sm_count(q.device)))}
        for b in ("parent", "change"):
            got = builds[b].flash_attention(q, k, v)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            res[f"{b}_max_abs_err"] = err
            res[f"{b}_differ"] = float((got != plain).float().mean())
            if not (torch.isfinite(got).all() and err <= tol
                    and torch.allclose(got.float(), want, atol=tol, rtol=tol)):
                fails.append(f"flash {b} {name}: max_abs_err {err}")
        nbytes, flops = cs.flash_work(torch, q, k, True, None)
        res["bound_ms"], res["bound_by"] = cs.bound(nbytes, flops, "bfloat16")
        # p.V in three bf16 parts: 8 D flops a visible pair issued
        res["three_part_floor_ms"] = 2 * flops / cs.PEAK_FLOPS["bfloat16"] * 1e3

        def sdpa():
            return cs.time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), flush)

        res["library_ms"] = [sdpa()]
        res["plain_ms"] = cs.time_ms(torch, lambda: builds["change"].flash_attention_plain(
            q, k, v), flush, iters=10)
        res["kernel_ms"] = in_turns(builds, lambda m: cs.time_ms(
            torch, lambda: m.flash_attention(q, k, v), flush))
        res["library_ms"].append(sdpa())
        res["issued_tflops"] = {b: [round(2 * flops / (ms * 1e-3) / 1e12, 1) for ms in times]
                                for b, times in res["kernel_ms"].items()}
        out[name] = res
        cs.log(f"[flash] {name}: {json.dumps(res)}")
        del q, k, v, want
    return out


def route_phase(torch, cs, builds, flush, fails):
    gen = torch.Generator(device="cuda").manual_seed(28)
    out = {}
    for name, (T, d, E, k, C) in ROUTE.items():
        x = torch.randn((T, d), generator=gen, device="cuda")
        w = torch.randn((d, E), generator=gen, device="cuda") * 0.02
        res = {}
        for b in ("parent", "change"):
            rt = builds[b]
            got = rt.moe_route(x, w, k, C)
            torch.cuda.synchronize()
            want = builds["change"].route_logits_plain(got.logits, k, C)
            exact = all(torch.equal(getattr(got, f), getattr(want, f).to(torch.int32))
                        for f in ("idx", "slot", "src", "counts"))
            err = max((got.probs - want.probs).abs().max().item(),
                      (got.vals - want.vals).abs().max().item(),
                      abs(float(got.aux) - float(want.aux)))
            res[f"{b}_exact"], res[f"{b}_max_abs_err"] = exact, err
            if not (exact and err <= cs.ROUTE_TOL):
                fails.append(f"route {b} {name}: exact {exact}, max_abs_err {err}")
        nbytes = 4 * (T * d + d * E + 2 * T * E + 3 * T * k + E * C + E + 1)
        res["bound_ms"], res["bound_by"] = cs.bound(nbytes, 2.0 * T * d * E)

        def mm():
            return cs.time_ms(torch, lambda: torch.mm(x, w), flush)

        res["library_ms"] = [mm()]
        res["plain_ms"] = cs.time_ms(torch, lambda: builds["change"].moe_route_plain(
            x, w, k, C), flush, iters=10)
        order = TURNS
        if name in SPLIT:
            order = ("parent", "parent_phase1", "change", "change_phase1",
                     "change_phase1", "change", "parent_phase1", "parent")
        res["kernel_ms"] = in_turns(builds, lambda m: cs.time_ms(
            torch, lambda: m.moe_route(x, w, k, C), flush), order)
        res["library_ms"].append(mm())
        out[name] = res
        cs.log(f"[route] {name}: {json.dumps(res)}")
        del x, w
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of an earlier commit's src/repro_torch/kernels, unpacked")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns: torch.cuda.is_available() is false")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import router_topk as rt
    from repro_torch.launch.serve import strict_fp32

    t_start = time.perf_counter()
    smi = cs.gpu_line()
    cs.log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    strict_fp32()
    parent = args.parent.resolve()
    procs = start_builds(build, parent)
    build.build(["flash_attention", "router_topk"])
    for name, (proc, _) in procs.items():
        text = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise SystemExit(f"kernel_turns: nvcc failed on {name}:\n{text}")
    pk = parent / KERNELS
    change_so = build.library_path("router_topk")
    flash = {"parent": module_over(build, pk / "flash_attention.py", "parent_fa",
                                   OUT / "parent_flash_attention.so"),
             "change": fa}
    route = {"parent": module_over(build, pk / "router_topk.py", "parent_rt",
                                   OUT / "parent_router_topk.so"),
             "change": rt,
             "parent_phase1": module_over(build, pk / "router_topk.py", "parent_rt1",
                                          OUT / "parent_phase1_router_topk.so"),
             "change_phase1": module_over(build, ROOT / KERNELS / "router_topk.py",
                                          "change_rt1", OUT / "change_phase1_router_topk.so")}
    cs.log(f"[build] change router_topk {change_so.name}; parent from {parent}")
    flush = torch.ones(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
    one = torch.zeros(1, device="cuda")
    fails: list = []
    result = {"card": smi, "timer_floor_ms": cs.time_ms(torch, lambda: one.fill_(1.0), flush),
              "flash_bf16": flash_phase(torch, cs, flash, flush, fails),
              "route": route_phase(torch, cs, route, flush, fails)}
    cs.log(f"[kernel_turns] took {time.perf_counter() - t_start:.1f} s")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "kernel_turns.json").write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps({"kernel_turns": result}))
    if fails:
        raise SystemExit("kernel_turns: " + "; ".join(fails))


if __name__ == "__main__":
    main()
