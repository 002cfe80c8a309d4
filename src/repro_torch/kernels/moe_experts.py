"""The expert SwiGLU of an MoE layer over the filled capacity slots: a
hand-written CUDA kernel and its plain version.

No TPU kernel: the JAX package computes the experts as einsums over all
``E * C`` slots in XLA (``repro/models/moe.py:127-131``).  Slot ``r`` of
expert ``e`` holds a token only for ``r < min(counts[e], C)``, and
``moe_combine`` reads no other slot.

* :func:`moe_experts` ``(xe (E, C, d), counts (E,), wi_gate (E, d, F),
  wi_up (E, d, F), wo (E, F, d), assignments) → ye (E, C, d)``:
  ``ye[e, r] = (silu(xe[e, r] @ wi_gate[e]) * (xe[e, r] @ wi_up[e])) @
  wo[e]`` for the filled rows only.  float32 runs on the CUDA cores (no
  TF32); bfloat16 on the tensor cores with float32 sums, ``h`` and ``ye``
  rounded to bfloat16 once each.  Two launches of ``csrc/moe_experts.cu``
  on the current stream, counted once a call in ``moe_experts.launches``:
  gate, up and SwiGLU into ``h (E, C, F)``, then ``wo``.  The counts stay
  on the card: the kernel reads them, and a block whose rows lie past its
  expert's count leaves at once.  **The rows at or past the count of
  ``ye`` (and of ``h``) are not written: they hold whatever
  ``torch.empty`` gave**, which is sound because the combine reads kept
  slots only.
* :func:`moe_experts_plain` is the einsums the path ran before, over
  every slot: the same filled rows, bit for bit the same products.

A float32 launch is planned here from the shapes alone
(:func:`experts_plan`): the mean filled rows an expert, ``min(C,
ceil(assignments / E))``, with ``assignments`` the T·k routed pairs,
picks the skinny plan (a few rows an expert: bound by the weight bytes)
or a tiled one (bound by the arithmetic).  bfloat16 has one plan, 128
rows by 256 columns a block, at every shape.  The gate and up launch adds the rows it computed to a
device counter, one atomic an expert (:func:`expert_rows`);
``moe_experts.slots`` counts the ``E * C`` slots offered, on the host.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.models import nn


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.moe_experts_gate_up.argtypes = [I] + [P] * 6 + [I] * 4 + [P]
    lib.moe_experts_gate_up.restype = I
    lib.moe_experts_down.argtypes = [I] + [P] * 4 + [I] * 4 + [P]
    lib.moe_experts_down.restype = I
    lib.moe_experts_gate_up_bf16.argtypes = [P] * 6 + [I] * 4 + [P]
    lib.moe_experts_gate_up_bf16.restype = I
    lib.moe_experts_down_bf16.argtypes = [P] * 4 + [I] * 4 + [P]
    lib.moe_experts_down_bf16.restype = I


#: the float32 kernel's plans, by their code in the C interface
PLANS = {"skinny": 0, "tiled": 1}
# mean filled rows an expert up to which the skinny plan runs: on the H100
# it led the tiled plan at 64 (phi3.5-moe's prefill of 512 tokens) and
# trailed it at 256 (PERF.md)
SKINNY_ROWS = 64


def experts_plan(E: int, C: int, assignments: int) -> str:
    """The plan for ``assignments`` (T·k) routed over ``E`` experts of
    ``C`` slots each, from the mean filled rows an expert."""
    rows = min(C, math.ceil(assignments / max(E, 1)))
    return "skinny" if rows <= SKINNY_ROWS else "tiled"


def _check(xe, counts, wi_gate, wi_up, wo) -> None:
    E, C, d = xe.shape if xe.dim() == 3 else (None,) * 3
    F = wi_gate.shape[-1] if wi_gate.dim() == 3 else None
    if (E is None or tuple(counts.shape) != (E,) or tuple(wi_gate.shape) != (E, d, F)
            or tuple(wi_up.shape) != (E, d, F) or tuple(wo.shape) != (E, F, d)):
        raise ValueError(
            f"moe_experts: xe must be (E, C, d), counts (E,), wi_gate and wi_up (E, d, F) "
            f"and wo (E, F, d), got {tuple(xe.shape)}, {tuple(counts.shape)}, "
            f"{tuple(wi_gate.shape)}, {tuple(wi_up.shape)} and {tuple(wo.shape)}")


# elements of one 16-byte copy, by the dtypes the kernel takes
_VEC = {torch.float32: 4, torch.bfloat16: 8}

# per device: the rows the gate and up launches computed, int64
_rows: Dict[int, torch.Tensor] = {}


def _rows_counter(device: torch.device) -> torch.Tensor:
    buf = _rows.get(device.index)
    if buf is None:
        buf = _rows[device.index] = torch.zeros(1, dtype=torch.int64, device=device)
    return buf


def expert_rows() -> int:
    """Rows the kernel has computed so far, over every card it ran on: a
    read of the device counters, so a host sync; never call it in a step."""
    return sum(int(t.item()) for t in _rows.values())


def moe_experts(xe: torch.Tensor, counts: torch.Tensor, wi_gate: torch.Tensor,
                wi_up: torch.Tensor, wo: torch.Tensor, assignments: int) -> torch.Tensor:
    """The expert SwiGLU of the filled slots on the card → ``ye (E, C,
    d)`` in the inputs' dtype (float32 or bfloat16, all four alike), its
    rows at or past ``min(counts[e], C)`` left unwritten.
    ``assignments`` (T·k) plans a float32 launch."""
    _check(xe, counts, wi_gate, wi_up, wo)
    ts = (xe, counts, wi_gate, wi_up, wo)
    if not xe.is_cuda or any(t.device != xe.device or not t.is_contiguous() for t in ts):
        raise ValueError(f"moe_experts: every input must be contiguous on one CUDA device, "
                         f"got {xe.device}")
    if xe.dtype not in _VEC or any(t.dtype != xe.dtype for t in (wi_gate, wi_up, wo)) or (
            counts.dtype != torch.int32):
        raise ValueError(f"moe_experts: the kernel takes float32 or bfloat16 rows and "
                         f"weights of one dtype and int32 counts, got {xe.dtype}, "
                         f"{wi_gate.dtype}, {wi_up.dtype}, {wo.dtype} and {counts.dtype}")
    E, C, d = xe.shape
    F = wi_gate.shape[-1]
    vec = _VEC[xe.dtype]
    if d % vec or F % vec or any(t.data_ptr() % 16 for t in (xe, wi_gate, wi_up, wo)):
        raise ValueError(f"moe_experts: d and F must be multiples of {vec} ({xe.dtype}: 16 "
                         f"bytes) and every pointer 16-byte aligned, got d={d}, F={F}")
    if E * C == 0 or d == 0:  # nothing to launch, so nothing to count
        return xe.new_empty((E, C, d))
    h = xe.new_empty((E, C, F))
    ye = xe.new_empty((E, C, d))
    lib = build.library("moe_experts", _bind)
    if xe.dtype == torch.bfloat16:  # one plan at every shape
        gate_up, down = lib.moe_experts_gate_up_bf16, lib.moe_experts_down_bf16
    else:
        code = PLANS[experts_plan(E, C, assignments)]
        gate_up = functools.partial(lib.moe_experts_gate_up, code)
        down = functools.partial(lib.moe_experts_down, code)
    with torch.cuda.device(xe.device):
        stream = torch.cuda.current_stream(xe.device).cuda_stream
        rows = _rows_counter(xe.device)
        err = gate_up(xe.data_ptr(), counts.data_ptr(), wi_gate.data_ptr(), wi_up.data_ptr(),
                      h.data_ptr(), rows.data_ptr(), E, C, d, F, stream)
        build.check(lib, err, "moe_experts (gate, up)")
        err = down(h.data_ptr(), counts.data_ptr(), wo.data_ptr(), ye.data_ptr(), E, C, F, d,
                   stream)
        build.check(lib, err, "moe_experts (down)")
    moe_experts.launches += 1
    moe_experts.slots += E * C
    return ye


moe_experts.launches = 0
moe_experts.slots = 0


def moe_experts_plain(xe: torch.Tensor, counts: torch.Tensor, wi_gate: torch.Tensor,
                      wi_up: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`moe_experts`: the einsums of
    ``repro/models/moe.py:127-131`` over every slot (an empty slot's row
    is whatever its ``xe`` row gives: 0 from the dispatch); ``counts``
    changes nothing here."""
    _check(xe, counts, wi_gate, wi_up, wo)
    h = nn.silu(torch.einsum("ecd,edf->ecf", xe, wi_gate)) * torch.einsum(
        "ecd,edf->ecf", xe, wi_up)
    return torch.einsum("ecf,efd->ecd", h, wo)
