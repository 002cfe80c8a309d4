"""Time ``moe_dispatch`` and ``moe_combine`` against other builds of their
source, in turns, on one NVIDIA card.

Run from the repository root, with an earlier commit's CUDA sources
unpacked into a directory that ``.gitignore`` lists::

    mkdir -p build/parent
    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 tools/moe_turns.py --parent build/parent/src/repro_torch/kernels/csrc/moe_dispatch.cu

Four builds of the two kernels take turns on the same inputs, in the
order ``change, parent, nopdl, prewait`` and back (each twice):

* ``change``: this checkout's kernels, through their wrappers;
* ``parent``: the ``--parent`` source, whose C interface plans the grid
  itself (``moe_dispatch(x, src, xe, rows, d, stream)``,
  ``moe_combine(ye, slot, vals, y, T, d, k, drop, stream)``);
* ``nopdl``: this checkout's source without programmatic dependent
  launch: ``cudaLaunchKernelEx`` with no attribute (a plain launch) and
  no ``griddepcontrol.wait``;
* ``prewait``: this checkout's source with the combine staging its slots
  and gates before the wait, which is right only where they predate the
  previous launch (the forward's combine: ``moe_route`` wrote them before
  the dispatch and the expert products).  Timed here, not shipped.

Each build is first held bit for bit (``torch.equal``) to the plain
versions at every shape.  Then, per build: the cold-L2 time of one call
(``chip_smoke.time_ms``) at phi3.5-moe's decode and prefill, deepseek-v2-
lite's decode (T=2, 8) and T=4096, and the dispatch's backward (the
combine with unit gates) at phi3.5-moe's training shape, there also with
one vector a thread (``change_vpt1``); the time of one queued chain
(``moe_route``, the dispatch, a product standing in for the experts', the
combine), 64 chains queued behind a spin so that the card runs them back
to back, as a CUDA graph would; and in place, µs a launch and device busy
ms a step in ``chip_smoke.serve_phase``'s profile of phi3.5-moe (8
layers) and ``chip_smoke.greedy_decode_run``'s of deepseek-v2-lite (27
layers), each profile taken again in turns after the smoke's own.

Prints ``[kernels]``, ``[chain]``, ``[serve]`` and ``[decode]`` lines,
the ``nvidia-smi`` name and power limit, and last one JSON object
``{"moe_turns": {...}}`` with every mean.  Exits non-zero if a build
differs from the plain versions or any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "moe_turns"
TURNS = ("change", "parent", "nopdl", "prewait", "prewait", "nopdl", "parent", "change")
CHAIN_LEAD_CYCLES = 100_000_000  # about 50 ms of spinning while the host queues
CHAIN_N = 64

# the builds of this checkout's source: (text, replacement) pairs, each
# found exactly once
WAIT = '  asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n'
STAGED = "    s_val[i] = __ldcg(vals + base + i);\n  }\n  __syncthreads();\n"
VARIANTS = {
    "nopdl": ((WAIT, ""), ("  cfg.numAttrs = 1;\n", "  cfg.numAttrs = 0;\n")),
    "prewait": (("  float* s_val = reinterpret_cast<float*>(stage + Y * k);\n"
                 "  wait_for_previous_kernel();\n",
                 "  float* s_val = reinterpret_cast<float*>(stage + Y * k);\n"),
                (STAGED, STAGED + "  wait_for_previous_kernel();\n")),
}

# name: (T, d, E, k, C); the cold shapes
SHAPES = {"phi3.5-moe decode T=8": (8, 4096, 16, 2, 1),
          "phi3.5-moe prefill T=47": (47, 4096, 16, 2, 7),
          "deepseek-v2-lite decode T=2": (2, 2048, 64, 6, 1),
          "deepseek-v2-lite decode T=8": (8, 2048, 64, 6, 1),
          "deepseek-v2-lite T=4096": (4096, 2048, 64, 6, 480)}
BACKWARD = ("phi3.5-moe train T=2048 (dispatch's backward)", (2048, 4096, 16, 2, 320))
CHAINS = ("phi3.5-moe decode T=8", "deepseek-v2-lite decode T=2")


def sources(parent: Path):
    """``{name: .cu path}`` of the three other builds, the variants written
    into ``OUT``."""
    text = (CSRC / "moe_dispatch.cu").read_text()
    out = {"parent": parent}
    OUT.mkdir(parents=True, exist_ok=True)
    for name, subs in VARIANTS.items():
        v = text
        for a, b in subs:
            if v.count(a) != 1:
                raise SystemExit(f"moe_turns: {name}: {a!r} found {v.count(a)} times")
            v = v.replace(a, b)
        out[name] = OUT / f"{name}.cu"
        out[name].write_text(v)
    return out


def start_builds(srcs, build):
    """One ``nvcc`` a source, all started together → ``{name: (proc, .so)}``."""
    procs = {}
    for name, src in srcs.items():
        so = OUT / f"{name}.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(CSRC), "-o", str(so), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    return procs


def load(procs, md):
    libs = {}
    for name, (proc, so) in procs.items():
        text = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise SystemExit(f"moe_turns: nvcc failed on {name}:\n{text}")
        lib = ctypes.CDLL(str(so))
        lib.tpp_error_string.argtypes = [ctypes.c_int]
        lib.tpp_error_string.restype = ctypes.c_char_p
        if name == "parent":
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.moe_dispatch.argtypes = [P, P, P, ctypes.c_int64, I, P]
            lib.moe_combine.argtypes = [P, P, P, P, I, I, I, I, P]
            lib.moe_dispatch.restype = lib.moe_combine.restype = I
        else:
            md._bind(lib)
        libs[name] = lib
    return libs


def wrappers(torch, lib, parent, one_vector=False):
    """``(dispatch, combine)`` over ``lib`` with the wrappers' signatures;
    the grid planned as the wrappers plan it (one vector a combine thread
    if ``one_vector``), or by ``lib`` itself for the parent's interface."""
    from repro_torch.kernels import build
    from repro_torch.kernels import moe_dispatch as md

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def dispatch(x, src, E, C):
        d = x.shape[1]
        xe = torch.empty((E, C, d), device=x.device)
        dtype, plan = (), ()
        if not parent:  # float32 (0) ahead, the plan behind
            vec = md._vec(d, x, xe)
            p = md.glue_plan(E * C, d // 4 if vec else d, build.sm_count(x.device))
            dtype, plan = (0,), (vec, p["bx"], p["by"])
        build.check(lib, lib.moe_dispatch(*dtype, x.data_ptr(), src.data_ptr(),
                                          xe.data_ptr(), E * C, d, *plan, stream()),
                    "moe_dispatch")
        return xe

    def combine(ye, slot, vals, round_each=False):  # a no-op in float32
        E, C, d = ye.shape
        T, k = vals.shape
        y = torch.empty((T, d), device=ye.device)
        dtype, plan = (), ()
        if not parent:  # float32 (0) ahead; round_each and the plan behind
            vec = md._vec(d, ye, y)
            n, sms = d // 4 if vec else d, build.sm_count(ye.device)
            p = (md.glue_plan(T, n, sms, max_y=md.STAGE_BYTES // (8 * k)) if one_vector
                 else md.combine_plan(T, n, k, sms))
            dtype, plan = (0,), (int(round_each), vec, p["vpt"], p["bx"], p["by"])
        build.check(lib, lib.moe_combine(*dtype, ye.data_ptr(), slot.data_ptr(),
                                         vals.data_ptr(), y.data_ptr(), T, d, k, E * C,
                                         *plan, stream()),
                    "moe_combine")
        return y

    return dispatch, combine


@contextlib.contextmanager
def using(fns):
    """The MoE wrappers replaced by ``fns`` inside the block (``None``:
    this checkout's own)."""
    from repro_torch.kernels import moe_dispatch as md

    saved = md.moe_dispatch, md.moe_combine
    if fns is not None:
        md.moe_dispatch, md.moe_combine = fns
    try:
        yield
    finally:
        md.moe_dispatch, md.moe_combine = saved


def in_turns(builds, measure, order=TURNS):
    """``measure()`` under each build in ``order`` → ``{build: [..]}``."""
    out = {}
    for name in order:
        with using(builds[name]):
            out.setdefault(name, []).append(measure())
    return out


def mean(xs):
    return sum(xs) / len(xs)


def cold_phase(torch, cs, builds, fails):
    """Bit for bit checks and cold times at ``SHAPES`` and ``BACKWARD``."""
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(23)
    flush = torch.ones(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
    one = torch.zeros(1, device="cuda")
    out = {"timer_floor_ms": cs.time_ms(torch, lambda: one.fill_(1.0), flush)}
    for name, (T, d, E, k, C) in {**SHAPES, BACKWARD[0]: BACKWARD[1]}.items():
        backward = name == BACKWARD[0]
        if backward:
            x, w, r = cs.biased_route(torch, gen, T, d, E, k, C)
        else:
            x = torch.randn((T, d), generator=gen, device="cuda")
            w = torch.randn((d, E), generator=gen, device="cuda") * 0.02
            r = ops.moe_route(x, w, k, C, impl="kernel")
        ye = torch.randn((E, C, d), generator=gen, device="cuda")
        vals = torch.ones_like(r.vals) if backward else r.vals
        want_xe = md.moe_dispatch_plain(x, r.src, E, C)
        want_y = md.moe_combine_plain(ye, r.slot, vals)
        order = (("change", "change_vpt1") + TURNS[1:-1] + ("change_vpt1", "change")
                 if backward else TURNS)
        for b in dict.fromkeys(order):
            with using(builds[b]):
                ok = (torch.equal(md.moe_dispatch(x, r.src, E, C), want_xe)
                      and torch.equal(md.moe_combine(ye, r.slot, vals), want_y))
            if not ok:
                fails.append(f"{b} differs from the plain versions at {name}")
        kept = int((r.src >= 0).sum())
        rows = int(torch.unique(r.src[r.src >= 0]).numel())
        res = {"combine_bound_ms": cs.bound(4 * (kept * d + 2 * T * k + T * d),
                                            2.0 * T * k * d)[0],
               "combine_ms": in_turns(builds, lambda: cs.time_ms(
                   torch, lambda: md.moe_combine(ye, r.slot, vals), flush), order)}
        if not backward:
            res["dispatch_bound_ms"] = cs.bound(4 * (rows * d + E * C + E * C * d), 0.0)[0]
            res["dispatch_ms"] = in_turns(builds, lambda: cs.time_ms(
                torch, lambda: md.moe_dispatch(x, r.src, E, C), flush))
        out[name] = res
        cs.log(f"[kernels] {name}: cold L2 ms in turns {json.dumps(res)}")
    return out


def chain_phase(torch, cs, builds):
    """One chain's device time, ``CHAIN_N`` chains queued behind a spin."""
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import router_topk as rt

    gen = torch.Generator(device="cuda").manual_seed(24)
    out = {}
    for name in CHAINS:
        T, d, E, k, C = SHAPES[name]
        x = torch.randn((T, d), generator=gen, device="cuda")
        w = torch.randn((d, E), generator=gen, device="cuda") * 0.02

        def chain():
            r = rt.moe_route(x, w, k, C)
            ye = torch.mul(md.moe_dispatch(x, r.src, E, C), 0.5)
            return md.moe_combine(ye, r.slot, r.vals)

        def queued():
            for _ in range(3):
                chain()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(CHAIN_LEAD_CYCLES)
            start.record()
            t0 = time.perf_counter()
            for _ in range(CHAIN_N):
                chain()
            host_ms = 1e3 * (time.perf_counter() - t0)
            end.record()
            torch.cuda.synchronize()
            return {"chain_ms": start.elapsed_time(end) / CHAIN_N, "host_queue_ms": host_ms}

        out[name] = in_turns(builds, queued)
        cs.log(f"[chain] {name}: route, dispatch, product, combine, {CHAIN_N} queued "
               f"{json.dumps(out[name])}")
    return out


def profiled_in_turns(cs, builds, profile, tag, store):
    """``profile`` wrapped: after the call it is given, the same profile
    again under each build in turns; its µs a launch of the dispatch and
    the combine and device ms a step go into ``store[tag]``."""

    def wrapped(*args, **kwargs):
        first = profile(*args, **kwargs)

        def measure():
            prof = profile(*args, **kwargs)
            own = prof["port_kernels_in_place"]
            return {"moe_dispatch_us": own["moe_dispatch"]["us_per_launch"],
                    "moe_combine_us": own["moe_combine"]["us_per_launch"],
                    "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
                    "wall_ms_per_step": prof["wall_ms_per_step"],
                    "top_device_ops_ms_per_step": prof["top_device_ops_ms_per_step"]}

        store[tag] = in_turns(builds, measure)
        cs.log(f"[{tag}] in place in turns {json.dumps(store[tag])}")
        return first

    return wrapped


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="an earlier commit's moe_dispatch.cu (its common.cuh beside it)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("moe_turns: torch.cuda.is_available() is false")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import TppConfig
    from repro_torch.kernels import build
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.launch import generate, serve
    from repro_torch.models.model import init_params
    from repro_torch.serving import EngineConfig

    t_start = time.perf_counter()
    smi = cs.gpu_line()
    cs.log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    serve.strict_fp32()
    procs = start_builds(sources(args.parent.resolve()), build)
    build.build()
    libs = load(procs, md)
    builds = {"change": None,
              "change_vpt1": wrappers(torch, build.library("moe_dispatch", md._bind), False,
                                      one_vector=True)}
    builds.update({n: wrappers(torch, lib, n == "parent") for n, lib in libs.items()})
    fails: list = []
    result = {"card": smi, "cold": cold_phase(torch, cs, builds, fails)}
    if fails:
        raise SystemExit("moe_turns: " + "; ".join(fails))
    result["chain"] = chain_phase(torch, cs, builds)
    gc.collect()
    torch.cuda.empty_cache()

    # in place: the smoke's phi3.5-moe serve run and deepseek greedy run
    store: dict = {}
    serve.profile_decode = profiled_in_turns(cs, builds, serve.profile_decode, "serve", store)
    generate.profile_decode_steps = profiled_in_turns(
        cs, builds, generate.profile_decode_steps, "decode", store)
    moe_full = get_config(cs.MOE_ARCH)  # as chip_smoke's main
    moe_cfg = dataclasses.replace(moe_full, stacks=((moe_full.stacks[0][0], cs.MOE_LAYERS),))
    ecfg = EngineConfig(page_size=16, num_fast=24, num_slow=64, topk_pages=4,
                        max_seqs=8, tpp=TppConfig(demote_budget=64, promote_budget=32))
    cs.serve_phase(torch, cs.MOE_ARCH, moe_cfg, ecfg)
    cfg = get_config(cs.DEEPSEEK)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    cs.greedy_decode_run(torch, cfg, params, smi, fails)
    del params
    if fails:
        raise SystemExit("moe_turns: " + "; ".join(fails))
    result["in_place"] = store

    def means(tree):
        """Each list of turns → its mean, key by key (keys every turn has)."""
        if isinstance(tree, dict):
            return {k: means(v) for k, v in tree.items()}
        if isinstance(tree, list) and isinstance(tree[0], dict):
            return {k: means([t[k] for t in tree]) for k in tree[0]
                    if all(k in t for t in tree)}
        return mean(tree) if isinstance(tree, list) else tree

    cs.log(f"[moe_turns] took {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"moe_turns": means(result)}))


if __name__ == "__main__":
    main()
