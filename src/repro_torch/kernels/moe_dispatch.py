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
* :func:`moe_combine_bwd` ``(dy (T, d), ye, slot, vals) → (dye (E, C,
  d), dvals (T, k))``, the gradient of the combine:
  ``dye[slot[t*k + j]] = vals[t, j] * dy[t]`` (each kept slot is filled
  by one assignment; a slot no token fills is 0) and ``dvals[t, j] =
  ⟨ye_flat[slot[t*k + j]], dy[t]⟩``, 0 for a dropped assignment.

All three launch ``csrc/moe_dispatch.cu`` on the current CUDA stream and
count their launches; the ``*_plain`` versions are what ``kernels.ops``
runs for a CPU tensor.  Float32 only.

:class:`Dispatch` and :class:`Combine` are their ``torch.autograd``
Functions, over the kernels or over the plain versions.  The combine's
backward is ``moe_combine_bwd``; the dispatch's is ``dx[t] = Σ_j
dxe_flat[slot[t*k + j]]`` (the gradient of the JAX package's scatter-add
at ``repro/models/moe.py:121-125``), which is ``moe_combine`` with unit
gates, so the dispatch needs ``slot`` beside ``src``.
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
    lib.moe_combine_bwd.argtypes = [P] * 6 + [I] * 4 + [P]
    lib.moe_combine_bwd.restype = I


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


MAX_K = 8  # gates a token the backward kernel keeps in registers


def _check_combine_bwd(dy: torch.Tensor, ye: torch.Tensor, slot: torch.Tensor,
                       vals: torch.Tensor) -> None:
    _check_combine(ye, slot, vals)
    if tuple(dy.shape) != (vals.shape[0], ye.shape[2]):
        raise ValueError(f"moe_combine_bwd: dy must be (T, d) = ({vals.shape[0]}, "
                         f"{ye.shape[2]}), got {tuple(dy.shape)}")


def moe_combine_bwd(dy: torch.Tensor, ye: torch.Tensor, slot: torch.Tensor,
                    vals: torch.Tensor):
    """The combine's gradient on the card → ``(dye (E, C, d), dvals (T, k))``."""
    _check_combine_bwd(dy, ye, slot, vals)
    _on_card("moe_combine_bwd", dy, ye, slot, vals)
    if (dy.dtype != torch.float32 or ye.dtype != torch.float32
            or vals.dtype != torch.float32 or slot.dtype != torch.int32):
        raise ValueError("moe_combine_bwd: dy, ye and vals must be float32 and slot int32")
    E, C, d = ye.shape
    T, k = vals.shape
    if k > MAX_K:
        raise ValueError(f"moe_combine_bwd: the kernel takes at most {MAX_K} gates a "
                         f"token, got {k}")
    dye = torch.empty_like(ye)
    dvals = torch.empty((T, k), dtype=torch.float32, device=ye.device)
    if T == 0 or d == 0 or E * C == 0:  # nothing to launch, so nothing to count
        dye.zero_()
        dvals.zero_()
        return dye, dvals
    lib = build.library("moe_dispatch", _bind)
    with torch.cuda.device(ye.device):
        stream = torch.cuda.current_stream(ye.device).cuda_stream
        code = lib.moe_combine_bwd(dy.data_ptr(), ye.data_ptr(), slot.data_ptr(),
                                   vals.data_ptr(), dye.data_ptr(), dvals.data_ptr(),
                                   T, d, k, E * C, stream)
    build.check(lib, code, "moe_combine_bwd")
    moe_combine_bwd.launches += 1
    return dye, dvals


moe_combine_bwd.launches = 0


def moe_combine_bwd_plain(dy: torch.Tensor, ye: torch.Tensor, slot: torch.Tensor,
                          vals: torch.Tensor):
    """Plain PyTorch version of :func:`moe_combine_bwd`: the rows each
    gate read, their dot products with ``dy``, and ``vals * dy`` written
    to the kept slots (every dropped assignment lands in the extra row
    ``E*C``, which is cut off)."""
    _check_combine_bwd(dy, ye, slot, vals)
    E, C, d = ye.shape
    T, K = vals.shape
    s = slot.long()
    ye_flat = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))], dim=0)
    dvals = (ye_flat[s].reshape(T, K, d) * dy[:, None, :]).sum(dim=-1)
    dye = ye.new_zeros((E * C + 1, d))
    dye[s] = (vals.to(dy.dtype)[:, :, None] * dy[:, None, :]).reshape(T * K, d)
    return dye[:E * C].reshape(E, C, d), dvals


# --------------------------------------------------------------------- #
# autograd
# --------------------------------------------------------------------- #
class Dispatch(torch.autograd.Function):
    """``xe = dispatch(x, src)``; ``dx = moe_combine(dxe, slot, 1)``."""

    @staticmethod
    def forward(ctx, x, src, slot, E, C, kernel):
        ctx.save_for_backward(slot)
        ctx.kernel, ctx.T = kernel, x.shape[0]
        return (moe_dispatch if kernel else moe_dispatch_plain)(x, src, E, C)

    @staticmethod
    def backward(ctx, dxe):
        (slot,) = ctx.saved_tensors
        T = ctx.T
        ones = torch.ones((T, slot.numel() // max(T, 1)), dtype=dxe.dtype,
                          device=dxe.device)
        combine = moe_combine if ctx.kernel else moe_combine_plain
        return combine(dxe.contiguous(), slot, ones), None, None, None, None, None


class Combine(torch.autograd.Function):
    """``y = combine(ye, slot, vals)``; its backward is ``moe_combine_bwd``."""

    @staticmethod
    def forward(ctx, ye, slot, vals, kernel):
        ctx.save_for_backward(ye, slot, vals)
        ctx.kernel = kernel
        return (moe_combine if kernel else moe_combine_plain)(ye, slot, vals)

    @staticmethod
    def backward(ctx, dy):
        ye, slot, vals = ctx.saved_tensors
        bwd = moe_combine_bwd if ctx.kernel else moe_combine_bwd_plain
        dye, dvals = bwd(dy.contiguous(), ye, slot, vals)
        return dye, None, dvals, None
