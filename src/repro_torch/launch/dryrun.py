"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on the
production meshes (counterpart of ``repro/launch/dryrun.py``).

JAX lowers each cell's step with ``ShapeDtypeStruct`` inputs and compiles
it on the production mesh.  The port's form of that is to run the step
once, eagerly, on ``meta`` tensors wrapped as DTensors over a fake
process group of 256 or 512 ranks (``launch/mesh.py``): nothing is
allocated, and DTensor's sharding propagation inserts the collectives
the placements need (the port's counterpart of GSPMD).  Params, AdamW
state (ZeRO-1 over ``data``), batch and decode state are built in
bfloat16 with the placements of ``launch/shardings.py``, each tensor
from its per-device shard.  The step is the port's own: ``loss_fn`` and
``optim.update`` under ``torch.autograd`` through ``make_train_step``
(microbatch accumulation per ``ACCUM``), ``forward(last_only=True)`` or
``decode_step``, at full depth with ``remat=True``, ``remat_policy``
from ``PERF``, ``impl="chunked"`` and the cell's ``ce_chunk``.

A :class:`CostCounter` sees every op this process (rank 0) runs on its
local shards and records, per device:

* ``flops``: matmul-class FLOPs (``torch.utils.flop_counter``'s table);
* ``bytes_accessed``: operand plus output bytes of every op that is not
  a view or an allocation;
* ``collective_bytes``: output bytes of each functional collective, by
  XLA's kind names, and ``collective_total``.

These are counts of the traced program, not device measurements.  The
eager trace runs every repeat, so ``cost_mode`` is ``"traced"`` and
JAX's unrolled extrapolation is not needed (``unrolled`` and
``with_reps`` are kept for callers).  ``argument_size_in_bytes`` and
``output_size_in_bytes`` are the per-device bytes of the step's inputs
and outputs; ``trace_s`` stands where JAX has ``compile_s``.
``temp_size_in_bytes`` and ``generated_code_size_in_bytes`` are XLA's
buffer assignment and code size and have no counterpart here.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out dryrun_results.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import optim
from repro_torch.configs import ALIASES, SHAPES, get_config
from repro_torch.launch.mesh import make_fake_mesh, make_production_mesh, mesh_scope
from repro_torch.launch.shardings import (
    shard_batch,
    shard_decode_state,
    shard_opt_state,
    shard_params,
    zero1_shardings,
)
from repro_torch.launch.train import make_train_step
from repro_torch.models import moe as moe_mod
from repro_torch.models import nn
from repro_torch.models.model import (
    ModelConfig,
    decode_step,
    forward,
    init_decode_state,
    init_params,
)
from repro_torch.optim.adamw import AdamWConfig

# long_500k runs only for sub-quadratic archs
LONG_OK = {"gemma3-4b", "xlstm-350m", "zamba2-2.7b"}

# per-arch train-time knobs of the JAX dry-run
CE_CHUNK_DEFAULT = 512  # stream unembed+CE: never materialize (B,S,V) fp32
CE_CHUNK = {"musicgen-medium": 0}  # 4-codebook labels; vocab is tiny (2048)
N_PATCHES = 256  # vlm stub prefix length
# microbatch accumulation: per-block remat stores the residual stream per
# layer boundary; archs where that is large step over microbatches
ACCUM = {
    "phi3-medium-14b": 8,
    "chatglm3-6b": 4,
    "gemma3-4b": 4,
    "musicgen-medium": 4,
    "phi3.5-moe-42b-a6.6b": 4,
    "deepseek-v2-lite-16b": 2,
    "zamba2-2.7b": 2,
}

# knobs a caller may set before run_cell
PERF = {
    "ce_onehot": False,   # one-hot CE contraction vs a gather
    "ce_chunk_override": None,  # chunk size for the streamed CE
    "remat_policy": None,  # None = full per-block remat | "dots" = save matmul outputs
    "moe_ep": True,  # expert-parallel layout constraints in moe_fwd
}


def unrolled(cfg: ModelConfig) -> ModelConfig:
    """Rewrite stacks to a single repeat (pattern unrolled)."""
    new_stacks = tuple((tuple(pat) * reps, 1) for pat, reps in cfg.stacks)
    return dataclasses.replace(cfg, stacks=new_stacks)


def with_reps(cfg: ModelConfig, reps: Tuple[int, ...]) -> ModelConfig:
    """Same architecture with per-stack repeat counts replaced."""
    new_stacks = tuple((pat, r) for (pat, _), r in zip(cfg.stacks, reps))
    return dataclasses.replace(cfg, stacks=new_stacks)


# --------------------------------------------------------------------- #
# input specs (meta stand-ins; no allocation)
# --------------------------------------------------------------------- #
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str,
                shape: Optional[Tuple[int, int, str]] = None) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of the workload shape
    (``shape`` = ``(seq, batch, kind)`` overrides ``SHAPES[shape_name]``)."""
    seq, batch, kind = shape or SHAPES[shape_name]
    i32 = torch.int32
    cb = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    if kind in ("train", "prefill"):
        d = {"tokens": _meta((batch, seq) + cb, i32)}
        if kind == "train":
            d["labels"] = _meta((batch, seq) + cb, i32)
        if cfg.vision_stub:
            d["patch_embeds"] = _meta((batch, N_PATCHES, cfg.d_model), torch.bfloat16)
        return d
    # decode: one new token against caches of length seq
    return {"tokens": _meta((batch, 1) + cb, i32), "cur_len": _meta((batch,), i32)}


# --------------------------------------------------------------------- #
# step builders
# --------------------------------------------------------------------- #
def _apply_moe_ep() -> None:
    moe_mod.EP_AXIS = "model" if PERF["moe_ep"] else None


def build_train(cfg: ModelConfig, arch: str, accum_override=None):
    """``train_step(params, opt_state, batch)`` of the cell, and its AdamW
    config: the port's ``make_train_step`` with the dry-run's knobs (the
    state is updated in place, as a donated JAX buffer would be)."""
    opt_cfg = AdamWConfig()
    ce_chunk = PERF["ce_chunk_override"] or CE_CHUNK.get(arch, CE_CHUNK_DEFAULT)
    accum = accum_override if accum_override is not None else ACCUM.get(arch, 1)
    step = make_train_step(cfg, opt_cfg, accum=accum, remat=True,
                           remat_policy=PERF["remat_policy"], impl="chunked",
                           ce_chunk=ce_chunk, ce_onehot=PERF["ce_onehot"], donate=True)
    return step, opt_cfg


def build_prefill(cfg: ModelConfig):
    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = forward(params, cfg, batch["tokens"],
                                patch_embeds=batch.get("patch_embeds"), impl="chunked",
                                remat=True, last_only=True)
        return logits

    return prefill_step


def build_serve(cfg: ModelConfig):
    def serve_step(params, states, batch):
        with torch.no_grad():
            return decode_step(params, cfg, batch["tokens"], states, batch["cur_len"])

    return serve_step


# --------------------------------------------------------------------- #
# per-device cost counter
# --------------------------------------------------------------------- #
#: functional collectives by XLA's kind names
COLLECTIVE_KINDS = (("all_reduce", "all-reduce"), ("all_gather", "all-gather"),
                    ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
                    ("permute", "collective-permute"))
_NO_DATA = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
            "detach", "lift_fresh", "alias", "_local_scalar_dense"}


def _tensors(tree) -> list:
    out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            out.extend(_tensors(x))
    elif isinstance(tree, dict):
        for x in tree.values():
            out.extend(_tensors(x))
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class CostCounter(TorchDispatchMode):
    """Counts the ops this process runs on plain tensors: on DTensors,
    the local ops the DTensor dispatcher issues for this rank (a DTensor
    op is passed on to DTensor, which then calls the local ops through
    this mode); the global-shape ops DTensor runs on fake tensors to
    propagate shapes are run and not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collective_bytes: Dict[str, int] = {}
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if types:  # fake tensors of DTensor's shape propagation
            return out
        self.ops += 1
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns in ("_c10d_functional", "c10d_functional", "_dtensor"):
            for key, kind in COLLECTIVE_KINDS:
                if key in name.replace("alltoall", "all_to_all"):
                    self.collective_bytes[kind] = (self.collective_bytes.get(kind, 0)
                                                   + _nbytes(_tensors(out)))
                    break
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view and name not in _NO_DATA:
            self.bytes_accessed += (_nbytes(_tensors(args)) + _nbytes(_tensors(kwargs))
                                    + _nbytes(_tensors(out)))
        return out

    def result(self) -> Dict[str, Any]:
        coll = dict(self.collective_bytes)
        return {"flops": float(self.flops), "bytes_accessed": float(self.bytes_accessed),
                "collective_bytes": coll, "collective_total": int(sum(coll.values()))}


# --------------------------------------------------------------------- #
# placed inputs
# --------------------------------------------------------------------- #
def distribute(tree: Any, shardings: Any, mesh) -> Any:
    """Each leaf of ``tree`` (``meta`` tensors) → a DTensor on ``mesh``
    with the leaf's ``Sharding``, built from an empty per-device shard."""
    def f(x, s):
        local = torch.empty(s.shard_shape(x.shape), dtype=x.dtype, device=x.device)
        return DTensor.from_local(local, mesh, s.placements, run_check=False,
                                  shape=x.shape, stride=x.stride())

    return nn.tree_map(f, tree, shardings)


def local_bytes(tree: Any) -> int:
    """Per-device bytes of a tree: a DTensor leaf counts its local shard."""
    total = 0
    for x in nn.tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            t = x.to_local() if isinstance(x, DTensor) else x
            total += t.numel() * t.element_size()
    return total


def step_inputs(cfg: ModelConfig, arch: str, shape_name: str, mesh, dtype,
                shape: Optional[Tuple[int, int, str]] = None, device="meta"
                ) -> Tuple[str, tuple, tuple]:
    """``(kind, inputs, shardings)`` of a cell: the step's arguments as
    ``meta`` tensors and their shardings on ``mesh``."""
    seq, batch, kind = shape or SHAPES[shape_name]
    params = init_params(cfg, torch.Generator(), device=device, dtype=dtype)
    p_shard = shard_params(params, mesh, cfg=cfg)
    specs = input_specs(cfg, shape_name, shape)
    b_shard = shard_batch(mesh, specs)
    if kind == "train":
        opt_state = optim.init(params, AdamWConfig())
        o_shard = shard_opt_state(opt_state, p_shard, mesh)
        o_shard = type(o_shard)(
            step=o_shard.step, m=zero1_shardings(o_shard.m, opt_state.m, mesh),
            v=zero1_shardings(o_shard.v, opt_state.v, mesh),
            master=(zero1_shardings(o_shard.master, opt_state.master, mesh)
                    if o_shard.master is not None else None))
        return kind, (params, opt_state, specs), (p_shard, o_shard, b_shard)
    if kind == "prefill":
        return kind, (params, specs), (p_shard, b_shard)
    states = init_decode_state(cfg, batch, seq, dtype=dtype, device=device)
    return kind, (params, states, specs), (p_shard, shard_decode_state(states, mesh), b_shard)


def predicted_argument_bytes(cfg: ModelConfig, arch: str, shape: Tuple[int, int, str],
                             mesh, dtype) -> int:
    """Per-device bytes of a step's arguments under the cell's shardings,
    from ``meta`` trees (shapes only)."""
    _, inputs, shardings = step_inputs(cfg, arch, "", mesh, dtype, shape=shape)
    total = 0
    for tree, sh in zip(inputs, shardings):
        for x, s in zip(nn.tree_leaves(tree), nn.tree_leaves(sh)):
            total += math.prod(s.shard_shape(x.shape)) * x.element_size()
    return total


def act_peak_est(cfg: ModelConfig, arch: str, kind: str, seq: int, batch: int,
                 n_dev: int, tp: int) -> int:
    """JAX's analytic per-device activation peak under per-block remat:
    the residual stream checkpoint per layer plus one block's live set."""
    dp = n_dev // tp  # data(-pod) shards
    if kind == "train":
        toks_dev = (batch // dp) * seq // ACCUM.get(arch, 1)
        resid = cfg.n_layers * toks_dev * cfg.d_model * 2  # bf16 checkpoints
        block_live = 6 * toks_dev * cfg.d_model * 4 // tp  # one block bwd (fp32)
        return int(resid + block_live)
    if kind == "prefill":
        toks_dev = (batch // dp) * seq
        return int(4 * toks_dev * cfg.d_model * 2 // max(tp // 4, 1))
    return 0  # decode: state-dominated (counted in args)


# --------------------------------------------------------------------- #
# one cell
# --------------------------------------------------------------------- #
def run_step(kind: str, cfg: ModelConfig, arch: str, args: tuple):
    """The cell's step on ``args`` → its outputs."""
    if kind == "train":
        step, _ = build_train(cfg, arch)
        return step(*args)
    if kind == "prefill":
        return build_prefill(cfg)(*args)
    return build_serve(cfg)(*args)


def count_step(kind: str, cfg: ModelConfig, arch: str, args: tuple
               ) -> Tuple[Dict[str, Any], Any, float]:
    """Run the step under a :class:`CostCounter` → ``(counts, outputs,
    seconds)``."""
    counter = CostCounter()
    t0 = time.time()
    with implicit_replication(), counter:
        out = run_step(kind, cfg, arch, args)
    return counter.result(), out, time.time() - t0


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             dtype=torch.bfloat16, verbose: bool = True, *,
             cfg: Optional[ModelConfig] = None,
             mesh_shape: Optional[Dict[str, int]] = None,
             shape: Optional[Tuple[int, int, str]] = None) -> Dict[str, Any]:
    """One (arch × shape × mesh) cell on the production mesh (or on a fake
    mesh of ``mesh_shape``, ``{axis: size}``, with ``cfg`` and ``shape``
    overriding the arch's config and the cell's shape: the tests' small
    cells)."""
    cfg = cfg or get_config(arch)
    seq, batch, kind = shape or SHAPES[shape_name]
    mesh_name = ("x".join(str(s) for s in mesh_shape.values()) if mesh_shape
                 else "2x16x16" if multi_pod else "16x16")
    if shape_name == "long_500k" and arch not in LONG_OK:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "skipped",
                "reason": "pure full-attention arch; long_500k needs sub-quadratic"}
    mesh = (make_fake_mesh(mesh_shape) if mesh_shape
            else make_production_mesh(multi_pod=multi_pod))
    with mesh_scope(mesh):
        _apply_moe_ep()
        kind, inputs, shardings = step_inputs(cfg, arch, shape_name, mesh, dtype, shape)
        args = tuple(distribute(t, s, mesh) for t, s in zip(inputs, shardings))
        arg_bytes = local_bytes(args)
        counts, out, trace_s = count_step(kind, cfg, arch, args)
        out_bytes = local_bytes(out)
        n_dev = mesh.size()
        tp = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))["model"]
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "ok",
        "trace_s": round(trace_s, 1), **counts, "n_devices": n_dev,
        "act_peak_est": act_peak_est(cfg, arch, kind, seq, batch, n_dev, tp),
        "cost_mode": "traced", "argument_size_in_bytes": int(arg_bytes),
        "output_size_in_bytes": int(out_bytes),
    }
    if verbose:
        print(json.dumps(result, indent=None))
    return result


def run_or_record(cell: Tuple[str, str, bool]) -> Dict[str, Any]:
    """:func:`run_cell`, a failure recorded with its error (a failing
    cell is a bug: it is counted, never hidden)."""
    arch, shape, mp = cell
    try:
        return run_cell(arch, shape, multi_pod=mp)
    except Exception as e:
        print(f"FAILED {arch} {shape} mp={mp}: {e}", flush=True)
        return {"arch": arch, "shape": shape, "mesh": "2x16x16" if mp else "16x16",
                "status": "FAILED", "error": f"{type(e).__name__}: {e}"[:500]}


def run_cells(cells: list, jobs: int = 1) -> list:
    """Every ``(arch, shape, multi_pod)`` cell, in order; ``jobs`` worker
    processes (each opens its own fake group) take the cells longest
    first: training cells, xlstm's sLSTM loop over time before them."""
    if jobs <= 1:
        return [run_or_record(c) for c in cells]
    import multiprocessing

    cost = lambda i: (SHAPES[cells[i][1]][2] != "train", cells[i][0] != "xlstm-350m")
    order = sorted(range(len(cells)), key=cost)
    with multiprocessing.get_context("spawn").Pool(jobs, maxtasksperchild=1) as pool:
        done = pool.map(run_or_record, [cells[i] for i in order], chunksize=1)
    out = [None] * len(cells)
    for i, r in zip(order, done):
        out[i] = r
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="every (arch × shape) cell")
    ap.add_argument("--out", default=None, help="write JSON results here")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes tracing cells side by side")
    args = ap.parse_args()

    cells = []
    if args.all:
        cells = [(arch, shape) for arch in ALIASES for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells.append((args.arch, args.shape))

    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    t0 = time.time()
    results = run_cells([(arch, shape, mp) for arch, shape in cells for mp in meshes],
                        args.jobs)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    n_fail = sum(1 for r in results if r["status"] == "FAILED")
    print(f"\ntraced in {time.time() - t0:.1f} s")
    print(f"dry-run: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED / {len(results)}")


if __name__ == "__main__":
    main()
