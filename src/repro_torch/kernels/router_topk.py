"""MoE router (softmax + top-k): a hand-written CUDA kernel and its plain version.

Counterpart of ``repro/kernels/router_topk.py``.  For router logits
``(T, E)`` it returns

* ``probs (T, E)`` float32: the softmax over experts;
* ``vals (T, k)`` float32: the top-k probabilities, renormalised to sum
  1 (the sum clamped at 1e-9);
* ``idx (T, k)`` int32: their experts, by iterated masked argmax, so a
  tie goes to the lower index, as ``jax.lax.top_k`` and the TPU kernel
  choose.

:func:`router_topk` launches ``csrc/router_topk.cu`` on the current CUDA
stream and counts its launches in ``router_topk.launches``.
:func:`router_topk_plain` (``repro/kernels/ref.py:91-98`` with the
kernel's tie order) is what ``kernels.ops`` runs for a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

MAX_EXPERTS = 256  # 32 lanes × 8 logits a lane in the kernel
MAX_K = 8


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.router_topk.argtypes = [P, P, P, P, I, I, I, P]
    lib.router_topk.restype = I


def _check(logits: torch.Tensor, k: int) -> None:
    if logits.dim() != 2:
        raise ValueError(f"router_topk: logits must be (T, E), got {tuple(logits.shape)}")
    E = logits.shape[1]
    if not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"router_topk: k={k} must lie in [1, min(E={E}, {MAX_K})]")


def router_topk(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Softmax + top-k + renormalise on the card → ``(probs, vals, idx)``."""
    _check(logits, k)
    if not logits.is_cuda:
        raise ValueError(f"router_topk: the CUDA kernel needs a CUDA tensor, got {logits.device}")
    if logits.dtype != torch.float32 or not logits.is_contiguous():
        raise ValueError("router_topk: logits must be contiguous float32")
    T, E = logits.shape
    if E > MAX_EXPERTS:
        raise ValueError(f"router_topk: the kernel takes at most {MAX_EXPERTS} experts, got {E}")
    probs = torch.empty_like(logits)
    vals = torch.empty((T, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((T, k), dtype=torch.int32, device=logits.device)
    if T == 0:  # nothing to launch, so nothing to count
        return probs, vals, idx
    lib = build.library("router_topk", _bind)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        code = lib.router_topk(logits.data_ptr(), probs.data_ptr(), vals.data_ptr(),
                               idx.data_ptr(), T, E, k, stream)
    build.check(lib, code, "router_topk")
    router_topk.launches += 1
    return probs, vals, idx


router_topk.launches = 0


def router_topk_plain(logits: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`router_topk`.

    Top-k is k rounds of ``argmax``, which returns the first maximum, not
    ``torch.topk``, whose order among ties is unspecified.
    """
    _check(logits, k)
    probs = torch.softmax(logits.float(), dim=-1)
    work = probs.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = work.argmax(dim=-1, keepdim=True)
        vals.append(work.gather(-1, i))
        idxs.append(i)
        work.scatter_(-1, i, -1.0)
    v = torch.cat(vals, dim=-1)
    v = v / v.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, v, torch.cat(idxs, dim=-1).to(torch.int32)
