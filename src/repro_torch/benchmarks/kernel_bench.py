"""Kernel microbenches: the four TPU kernels' counterparts at the JAX
benchmark's shapes.

Counterpart of ``benchmarks/kernel_bench.py`` (same cases, same line
names).  On a CUDA device each line times the hand-written Hopper kernel
through :mod:`repro_torch.kernels.ops`: mean device time of one call
over CUDA events, each call after a read of a 256 MB buffer (a cold L2)
and a 1 ms spin that hides the host's launch; beside it the plain
PyTorch version, the one PyTorch call that computes the same function
where there is one (``library_us``), and the least time the card could
take (``bound_us``: the bytes the call must move at the HBM rate, or its
FLOPs at the float32 peak, whichever is larger; ``common.py``).  On the
CPU it times the plain versions on the host clock and ``derived`` ends
in ``_ref``, as the JAX benchmark's does.  Nothing falls back: a CUDA
tensor launches the kernel or raises.

  PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench --device cpu
  python -m repro_torch.benchmarks.kernel_bench        # on the card
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.benchmarks.common import HBM_BYTES_PER_S, PEAK_FLOPS
from repro_torch.kernels import ops

WARMUP = 3
ITERS = 50  # timed calls a case on the card
CPU_ITERS = 5  # as the JAX benchmark's ``_time``
FLUSH_BYTES = 256 * 2**20  # larger than the H100's 50 MB L2
LEAD_CYCLES = 2_000_000  # about 1 ms of spinning at the H100's clock


@dataclasses.dataclass
class Case:
    """One line: ``call(impl)`` runs the case through ``ops`` with
    ``impl="kernel"`` or ``"ref"``; ``kernel`` names the wrapper whose
    launches it counts; ``nbytes``/``flops`` are the work this call's
    inputs need."""

    name: str
    tag: str
    kernel: str
    call: Callable[[str], object]
    library: Optional[Callable[[], object]]
    nbytes: float
    flops: float


def cases(device="cuda", seed: int = 0) -> List[Case]:
    """The JAX benchmark's four cases on ``device``, inputs drawn from a
    generator seeded ``seed`` on that device."""
    import torch.nn.functional as F

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    out = []
    # flash_attention: causal GQA prefill, (1, 8, 512, 64) with Hkv=2
    q, k, v = randn(1, 8, 512, 64), randn(1, 2, 512, 64), randn(1, 2, 512, 64)
    B, H, S, D = q.shape
    pairs = S * (S + 1) // 2  # causal query-key pairs a head
    out.append(Case(
        "kernel/flash_attention_512", "B1_H8_S512_D64", "flash_attention",
        lambda impl: ops.flash_attention(q, k, v, impl=impl),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        nbytes=(2 * q.numel() + 2 * k.numel()) * 4, flops=4.0 * D * B * H * pairs))

    # paged_attention, length mode: every lane full (MP·P tokens)
    Fr, Hkv, P, D, B, MP = 128, 4, 16, 64, 8, 16
    qd = randn(B, 16, D)
    kp, vp = randn(Fr, Hkv, P, D), randn(Fr, Hkv, P, D)
    bt = torch.randint(0, Fr, (B, MP), generator=gen, device=dev, dtype=torch.int32)
    ln = torch.full((B,), MP * P, dtype=torch.int32, device=dev)
    frames = int(torch.unique(bt).numel())  # each referenced frame read once
    out.append(Case(
        "kernel/paged_attention", "B8_H16_P16xMP16", "paged_attention",
        lambda impl: ops.paged_attention(qd, kp, vp, bt, ln, impl=impl), None,
        nbytes=frames * 2 * Hkv * P * D * 4 + 2 * qd.numel() * 4 + bt.numel() * 4 + B * 4,
        flops=4.0 * B * 16 * MP * P * D))

    # page_gather: 32 of 256 frames of (16, 64); the frames by value, on the host
    src = randn(256, 16, 64)
    idx = torch.arange(32, dtype=torch.int32)
    idx_dev = idx.to(device=dev, dtype=torch.int64)
    out.append(Case(
        "kernel/page_gather_32", "256f_16x64", "page_gather",
        lambda impl: ops.page_gather(src, idx, impl=impl),
        lambda: src.index_select(0, idx_dev),
        nbytes=2 * 32 * 16 * 64 * 4 + idx.numel() * 4, flops=0.0))

    # router_topk: softmax, top-6 and renormalise over 64 experts
    T, E, topk = 4096, 64, 6
    logits = randn(T, E)
    out.append(Case(
        "kernel/router_topk_64e", "T4096_E64_k6", "router_topk",
        lambda impl: ops.router_topk(logits, topk, impl=impl), None,
        # logits read, probs written, vals and idx written; max, subtract,
        # exp, sum, divide a logit, then k rounds of a compare and a select
        nbytes=8 * T * E + 8 * T * topk, flops=T * E * (5.0 + 2 * topk)))
    return out


def bound_us(case: Case) -> tuple:
    """``(µs, "bytes" | "operations")``: the least time for the case's
    bytes at the HBM rate and its FLOPs at the float32 peak."""
    t_bytes = case.nbytes / HBM_BYTES_PER_S * 1e6
    t_ops = case.flops / PEAK_FLOPS["float32"] * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_us(fn: Callable[[], object], flush: torch.Tensor, iters: int = ITERS,
              warmup: int = WARMUP) -> float:
    """Mean device µs of one ``fn()`` on the card with a cold L2.

    Before each call the card reads the whole ``flush`` buffer (a sum
    into one element), which leaves L2 full of clean lines: writing the
    buffer instead would leave dirty lines whose write-back runs inside
    the timed call.  Then it spins for ``LEAD_CYCLES`` (a kernel that
    touches no memory) while the host queues the call, so the interval
    between the events holds the call's device work and not the host's
    Python and launch overhead.
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
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters * 1e3


def host_us(fn: Callable[[], object], iters: int = CPU_ITERS) -> float:
    """Mean host µs of one ``fn()`` after one warm-up call (CPU tensors)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def measure(device="cuda") -> List[Dict]:
    """One row a case.  On CUDA: ``us`` of the kernel (``WARMUP + ITERS``
    launches of its wrapper a case, nothing else launched), ``plain_us``,
    ``library_us`` (None where no one call computes the function) and
    the bound; on the CPU: ``us`` of the plain version."""
    dev = torch.device(device)
    rows = []
    if dev.type != "cuda":
        for c in cases(dev):
            rows.append({"name": c.name, "tag": c.tag, "impl": "ref",
                         "us": host_us(lambda: c.call("ref"))})
        return rows
    flush = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for c in cases(dev):
        b_us, b_by = bound_us(c)
        rows.append({
            "name": c.name, "tag": c.tag, "impl": "kernel", "kernel": c.kernel,
            "us": device_us(lambda: c.call("kernel"), flush),
            "plain_us": device_us(lambda: c.call("ref"), flush),
            "library_us": None if c.library is None else device_us(c.library, flush),
            "bound_us": b_us, "bound_by": b_by,
        })
    return rows


def line(row: Dict) -> str:
    derived = f"{row['tag']}_{row['impl']}"
    if row["impl"] == "kernel":
        lib = row["library_us"]
        derived += (f";plain_us={row['plain_us']:.3f}"
                    f";library_us={'none' if lib is None else f'{lib:.3f}'}"
                    f";bound_us={row['bound_us']:.4f}({row['bound_by']})")
    return f"{row['name']},{row['us']:.1f},{derived}"


def run(quick: bool = False, device="cuda") -> List[str]:
    del quick  # four cases either way
    return [line(r) for r in measure(device)]


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for row_line in run(device=args.device):
        print(row_line)
