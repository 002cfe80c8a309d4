"""Training driver of the port: step builder, fault-tolerant loop, CLI
(counterpart of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch tinyllama-1.1b            # on the card
    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke --device cpu --steps 3

:func:`make_train_step` builds ``train_step(params, opt_state, batch) →
(params, opt_state, metrics)``: loss → gradients (``torch.autograd``,
with microbatch accumulation) → AdamW, with the JAX step's semantics:
gradients summed over the microbatches and divided by ``accum``, the
loss their mean, the other metrics the last microbatch's; ``lr_scale =
schedule(step)``; a step whose gradient norm is not finite keeps the old
parameters and state and sets ``skipped``.

:func:`train_loop` is the JAX loop: seeded weights (the port's own,
``init_params`` from a ``torch.Generator``), restore from the newest
complete checkpoint, exact replay of the data stream to the resume
point, the straggler watchdog, async checkpoints every ``ckpt_every``
steps and a final blocking save (where the last step was just saved,
the loop waits for that write instead of writing the same state again:
a full-width tinyllama-1.1b state is 17.6 GB).
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, make_batches
from repro_torch.models import nn
from repro_torch.models.model import ModelConfig, init_params, loss_fn
from repro_torch.optim.adamw import AdamWConfig, cosine_schedule


# --------------------------------------------------------------------- #
# step builder
# --------------------------------------------------------------------- #
def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    schedule: Optional[Callable] = None, accum: int = 1,
                    remat: bool = False, impl: str = "chunked", donate: bool = False,
                    remat_policy: Optional[str] = None, ce_chunk: int = 0,
                    ce_onehot: bool = False):
    """Returns ``train_step(params, opt_state, batch) → (params, opt,
    metrics)``.  ``batch`` holds tensors on the parameters' device;
    ``remat_policy``, ``ce_chunk`` and ``ce_onehot`` go to ``loss_fn``.

    ``donate=True`` updates ``params`` and ``opt_state`` in place and
    returns them (JAX's buffer donation: one copy of the training state
    on the card); ``False`` leaves them untouched.  On DTensors (the
    dry-run) a microbatch is each device's slice of its own batch shard,
    and the gradient norm of ``meta`` tensors is taken as finite.
    """
    schedule = schedule or (lambda s: 1.0)

    def grad_fn(params, mb):
        leaves = nn.tree_leaves(params)
        req = [x.detach().requires_grad_(True) for x in leaves]  # same storage
        loss, metrics = loss_fn(nn.tree_unflatten(params, req), cfg, mb, impl=impl,
                                remat=remat, remat_policy=remat_policy,
                                ce_chunk=ce_chunk, ce_onehot=ce_onehot)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
        # a leaf the loss never reads (qwen2-vl's patch_proj without
        # patches) has a zero gradient, as in JAX
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(req, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def microbatch(x, i):
        if isinstance(x, DTensor):
            local = microbatch(x.to_local(), i)
            return DTensor.from_local(local, x.device_mesh, x.placements, run_check=False)
        if x.dim() >= 1 and x.shape[0] % accum == 0:
            return x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))[i]
        return x

    def slice_mb(batch, i):
        return {k: microbatch(x, i) for k, x in batch.items()}

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            # microbatch accumulation, in order: peak activations of 1/accum
            grads = [torch.zeros_like(x, dtype=torch.float32)
                     for x in nn.tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=grads[0].device)
            for i in range(accum):
                l, metrics, g = grad_fn(params, slice_mb(batch, i))
                grads = [a + b for a, b in zip(grads, g)]
                loss = loss + l
            grads = [g / accum for g in grads]
            loss = loss / accum

        lr_scale = schedule(opt_state.step)
        gnorm = optim.global_norm(grads)
        # NaN containment: a non-finite gradient norm keeps the old state
        ok = gnorm.device.type == "meta" or bool(torch.isfinite(gnorm))
        if ok:
            params, opt_state, opt_metrics = optim.update(
                nn.tree_unflatten(params, grads), opt_state, params, opt_cfg, lr_scale,
                inplace=donate, grad_norm=gnorm)
        else:
            opt_metrics = {"grad_norm": gnorm,
                           "lr": opt_cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32)}
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        metrics["skipped"] = torch.tensor(0 if ok else 1, dtype=torch.int32)
        return params, opt_state, metrics

    return train_step


# --------------------------------------------------------------------- #
# fault-tolerant loop
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class LoopReport:
    steps_run: int
    resumed_from: Optional[int]
    losses: list
    stragglers: int
    skipped: int
    grad_norms: list = dataclasses.field(default_factory=list)
    step_seconds: list = dataclasses.field(default_factory=list)


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A numpy batch of the data pipeline → tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_loop(cfg: ModelConfig, data_cfg: DataConfig, opt_cfg: AdamWConfig, steps: int,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 50, accum: int = 1,
               remat: bool = False, seed: int = 0, dtype=torch.float32,
               watchdog_factor: float = 3.0, log_every: int = 10, warmup: int = 20,
               device="cuda") -> LoopReport:
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device=device, dtype=dtype)
    opt_state = optim.init(params, opt_cfg)
    schedule = cosine_schedule(warmup, steps)
    step_fn = make_train_step(cfg, opt_cfg, schedule, accum=accum, remat=remat,
                              donate=True)

    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    resumed_from = None
    if manager is not None:
        got, restored = manager.restore_latest({"params": params, "opt": opt_state})
        if got is not None:
            params, opt_state = restored["params"], restored["opt"]
            start = got
            resumed_from = got
        del restored

    batches = make_batches(data_cfg, cfg)
    # fast-forward the stream to the resume point (the synthetic stream is
    # seeded per step, so this is exact replay)
    for _ in range(start):
        next(batches)

    report = LoopReport(steps_run=steps - start, resumed_from=resumed_from, losses=[],
                        stragglers=0, skipped=0)
    durations = report.step_seconds
    for step in range(start, steps):
        batch = next(batches)
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, to_device(batch, device))
        loss = float(metrics["loss"])
        dt = time.time() - t0
        durations.append(dt)
        report.losses.append(loss)
        report.grad_norms.append(float(metrics["grad_norm"]))
        report.skipped += int(metrics["skipped"])
        if len(durations) >= 8:
            med = statistics.median(durations[-32:])
            if dt > watchdog_factor * med:
                report.stragglers += 1
        if manager is not None and (step + 1) % ckpt_every == 0:
            manager.save(step + 1, {"params": params, "opt": opt_state})
        if log_every and (step + 1) % log_every == 0:
            print(f"step {step + 1:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt * 1e3:.0f}ms")
    if manager is not None:
        if start < steps and steps % ckpt_every == 0:
            manager.wait()  # the last step's save holds this very state
        else:
            manager.save(steps, {"params": params, "opt": opt_state}, blocking=True)
    return report


def profile_train_steps(step_fn: Callable, params, opt_state, batches: Iterator, device,
                        out_dir: str, steps: int = 2) -> Dict[str, Any]:
    """Trace ``steps`` training steps with ``torch.profiler``.

    Each step takes the next numpy batch of ``batches`` and ends in a
    host read of its loss, as in :func:`train_loop`.  Writes the per-op
    table (``ops.txt``) and a Chrome trace (``trace.json``) to
    ``out_dir`` and returns, per step, the wall time, the device busy
    time (the sum of the device events' own time: one stream, so they do
    not overlap), the idle share, the device launches, the time the
    profiler records as "Command Buffer Full" (a full launch queue, kept
    out of the busy time) and the top device ops.  Tracing slows the host; take step times from an untraced run.
    """
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 to_device(next(batches), device))
            float(metrics["loss"])
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # the device's own work: kernels, copies, fills; "Command Buffer Full"
    # is the profiler's record of a full launch queue, not device work
    dev = [e for e in ka if e.device_type.name == "CUDA" and e.key != "Command Buffer Full"]
    busy_us = sum(e.self_device_time_total for e in dev)
    queue_full_us = sum(e.self_device_time_total for e in ka if e.key == "Command Buffer Full")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "ops.txt").write_text(ka.table(
        sort_by="self_device_time_total" if cuda else "self_cpu_time_total", row_limit=40))
    prof.export_chrome_trace(str(out / "trace.json"))
    top = sorted((e for e in ka if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:10]
    wall_ms = wall * 1e3 / steps
    busy_ms = busy_us / 1e3 / steps
    return {"steps": steps, "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "device_launches_per_step": sum(e.count for e in dev) / steps,
            "command_buffer_full_ms_per_step": queue_full_us / 1e3 / steps,
            "top_device_ops_ms_per_step": {
                e.key: e.self_device_time_total / 1e3 / steps for e in top}}


# --------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------- #
def main() -> None:
    ap = argparse.ArgumentParser(description="train an assigned arch")
    from repro_torch.configs import get_config, get_smoke_config, list_archs

    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch.launch.serve import strict_fp32

    strict_fp32()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    data_cfg = DataConfig(seq_len=args.seq_len, global_batch=args.batch)
    report = train_loop(cfg, data_cfg, AdamWConfig(lr=args.lr), steps=args.steps,
                        ckpt_dir=args.ckpt_dir, accum=args.accum, device=args.device)
    print(f"done: {report.steps_run} steps, resumed_from={report.resumed_from}, "
          f"final loss {report.losses[-1]:.4f}")


if __name__ == "__main__":
    main()
