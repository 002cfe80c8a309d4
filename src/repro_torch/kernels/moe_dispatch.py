"""MoE capacity dispatch and combine: hand-written CUDA kernels and their
plain versions.

The JAX package runs these two steps in XLA around the expert einsums
(``repro/models/moe.py:121-137``); there is no TPU kernel.

* :func:`moe_dispatch` ``(x (T, d), src (E*C,), E, C) → xe (E, C, d)``:
  slot ``s`` takes token row ``src[s]``, or zeros where ``src[s]`` is -1.
  Each kept slot holds exactly one row, so this equals the JAX
  package's scatter-add of the rows into zeros value for value.
* :func:`moe_combine` ``(ye (E, C, d), slot (T*k,), vals (T, k)) → y (T,
  d)``: ``y[t] = Σ_j vals[t, j] * ye_flat[slot[t*k + j]]`` summed over
  ``j`` in ascending order, a dropped assignment (``slot == E*C``)
  contributing a zero row.

Both launch ``csrc/moe_dispatch.cu`` on the current CUDA stream and
count their launches; the ``*_plain`` versions are what ``kernels.ops``
runs for a CPU tensor.  Float32 only.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.moe_dispatch.argtypes = [P, P, P, ctypes.c_int64, I, P]
    lib.moe_dispatch.restype = I
    lib.moe_combine.argtypes = [P, P, P, P, I, I, I, I, P]
    lib.moe_combine.restype = I


def _check_dispatch(x: torch.Tensor, src: torch.Tensor, E: int, C: int) -> None:
    if x.dim() != 2 or tuple(src.shape) != (E * C,):
        raise ValueError(f"moe_dispatch: x must be (T, d) and src (E*C,) = ({E * C},), "
                         f"got {tuple(x.shape)} and {tuple(src.shape)}")


def _check_combine(ye: torch.Tensor, slot: torch.Tensor, vals: torch.Tensor) -> None:
    if ye.dim() != 3 or vals.dim() != 2 or tuple(slot.shape) != (vals.numel(),):
        raise ValueError(f"moe_combine: ye must be (E, C, d), vals (T, k) and slot "
                         f"(T*k,), got {tuple(ye.shape)}, {tuple(vals.shape)} and "
                         f"{tuple(slot.shape)}")


def _on_card(what: str, *tensors: torch.Tensor) -> None:
    first = tensors[0]
    if not first.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, got {first.device}")
    for t in tensors:
        if t.device != first.device or not t.is_contiguous():
            raise ValueError(f"{what}: every input must be contiguous on {first.device}")


def moe_dispatch(x: torch.Tensor, src: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """The expert slots' rows on the card → ``xe (E, C, d)`` in x's type."""
    _check_dispatch(x, src, E, C)
    _on_card("moe_dispatch", x, src)
    if x.dtype != torch.float32 or src.dtype != torch.int32:
        raise ValueError("moe_dispatch: x must be float32 and src int32")
    d = x.shape[1]
    xe = torch.empty((E, C, d), dtype=x.dtype, device=x.device)
    if xe.numel() == 0:  # nothing to launch, so nothing to count
        return xe
    lib = build.library("moe_dispatch", _bind)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.moe_dispatch(x.data_ptr(), src.data_ptr(), xe.data_ptr(), E * C, d,
                                stream)
    build.check(lib, code, "moe_dispatch")
    moe_dispatch.launches += 1
    return xe


moe_dispatch.launches = 0


def moe_dispatch_plain(x: torch.Tensor, src: torch.Tensor, E: int, C: int
                       ) -> torch.Tensor:
    """Plain PyTorch version of :func:`moe_dispatch`: a gather from the
    rows of ``x`` and one zero row, which ``src == -1`` picks."""
    _check_dispatch(x, src, E, C)
    rows = torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)
    return rows[src.long()].reshape(E, C, x.shape[1])


def moe_combine(ye: torch.Tensor, slot: torch.Tensor, vals: torch.Tensor
                ) -> torch.Tensor:
    """The gated sum of each token's expert outputs on the card → ``y (T,
    d)``."""
    _check_combine(ye, slot, vals)
    _on_card("moe_combine", ye, slot, vals)
    if ye.dtype != torch.float32 or vals.dtype != torch.float32 or slot.dtype != torch.int32:
        raise ValueError("moe_combine: ye and vals must be float32 and slot int32")
    E, C, d = ye.shape
    T, k = vals.shape
    y = torch.empty((T, d), dtype=ye.dtype, device=ye.device)
    if y.numel() == 0:  # nothing to launch, so nothing to count
        return y
    lib = build.library("moe_dispatch", _bind)
    with torch.cuda.device(ye.device):
        stream = torch.cuda.current_stream(ye.device).cuda_stream
        code = lib.moe_combine(ye.data_ptr(), slot.data_ptr(), vals.data_ptr(),
                               y.data_ptr(), T, d, k, E * C, stream)
    build.check(lib, code, "moe_combine")
    moe_combine.launches += 1
    return y


moe_combine.launches = 0


def moe_combine_plain(ye: torch.Tensor, slot: torch.Tensor, vals: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of :func:`moe_combine`: the gather of
    ``repro/models/moe.py:133-135``, then the gated sum with its terms
    added in ascending ``j``, which fixes the order of the rounding."""
    _check_combine(ye, slot, vals)
    E, C, d = ye.shape
    T, K = vals.shape
    ye_flat = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))], dim=0)
    yk = ye_flat[slot.long()].reshape(T, K, d)
    g = vals.to(yk.dtype)
    y = yk[:, 0] * g[:, 0, None]
    for j in range(1, K):
        y = y + yk[:, j] * g[:, j, None]
    return y
