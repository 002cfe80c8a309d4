"""Flash attention (prefill): a hand-written CUDA kernel and its plain version.

Counterpart of ``repro/kernels/flash_attention.py``: ``q (B, H, S, D)``
attends over ``k, v (B, Hkv, T, D)``, query head ``h`` reading KV head
``h // (H // Hkv)``.  ``causal`` masks keys after the query (top-left
aligned: query ``i`` sees keys ``<= i``); ``window`` also masks keys at
or before ``i - window``.  The result is ``(B, H, S, D)`` in q's type.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` on the
current CUDA stream and counts its launches in
``flash_attention.launches``.  It takes the batch, head and position
strides of q, k and v, so a transposed view such as the engine's
``(B, S, H, D) → (B, H, S, D)`` prefill projections is read in place
with no copy; only the last dimension must be contiguous.
:func:`flash_attention_plain` (a port of ``repro/kernels/ref.py:12-37``)
is what ``kernels.ops`` runs for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.flash_attention.argtypes = (
        [I, P, P, P, P] + [I] * 6 + [I64] * 9 + [ctypes.c_float, I, I, I, P]
    )
    lib.flash_attention.restype = I


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)} must be (B, H, S, D) and (B, Hkv, T, D)")
    B, H, _, D = q.shape
    Bk, Hkv, _, Dk = k.shape
    if Bk != B or Dk != D or H % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention on the card → a contiguous ``(B, H, S, D)`` tensor."""
    _check_shapes(q, k, v)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: the CUDA kernel needs a CUDA tensor, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must all be float32 or all bfloat16")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: the last dimension of {name} must "
                             f"be contiguous, got strides {t.stride()}")
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} > {MAX_HEAD_DIM}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:  # nothing to launch, so nothing to count
        return out
    lib = build.library("flash_attention", _bind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, H, Hkv, S, T, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(causal), int(window is not None), int(window or 0),
            stream,
        )
    build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention` (full score matrix)."""
    _check_shapes(q, k, v)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.reshape(B, Hkv, G, S, D).float() * scale
    s = torch.einsum("bhgsd,bhtd->bhgst", qf, k.float())
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    o = torch.einsum("bhgst,bhtd->bhgsd", p, v.float())
    return o.reshape(B, H, S, D).to(q.dtype)
