"""Flash attention (prefill): a hand-written CUDA kernel and its plain version.

Counterpart of ``repro/kernels/flash_attention.py``: ``q (B, H, S, D)``
attends over ``k, v (B, Hkv, T, D)``, query head ``h`` reading KV head
``h // (H // Hkv)``.  ``causal`` masks keys after the query (top-left
aligned: query ``i`` sees keys ``<= i``); ``window`` also masks keys at
or before ``i - window``.  The result is ``(B, H, S, D)`` in q's type.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` on the
current CUDA stream and counts its launches in
``flash_attention.launches``.  It takes the batch, head and position
strides of q, k and v, so a transposed view such as the engine's ``(B,
S, H, D) → (B, H, S, D)`` prefill projections is read in place with no
copy; only the last dimension must be contiguous.  The kernel has two
paths (:func:`kernel_path` says which a call takes):

* **bfloat16 on Hopper's warpgroup tensor cores** (``"wgmma"``: rows
  16-byte aligned, D a multiple of 8, every stride of a dimension longer
  than 1 non-zero): ``wgmma`` for q·kᵀ and for p·V, float32 sums; p stays
  in registers, split into three bf16 parts that add up to it exactly, so
  p·V differs from float32 only in the order of its sums, and each key
  tile's p·V is added to the output in float32; warpgroups of 64 query
  rows over a TMA ring of key tiles, planned by :func:`wgmma_plan` (two a
  block, or two over alternate key tiles of the same rows, or one).
* **float32, and bf16 rows off that alignment, on the CUDA cores**:
  float32 register tiles of the scores and the output, 64-key tiles
  through a two-stage ring (element loads off alignment); the query
  tile (64, 32 or 16 rows) is picked from the grid's size against the
  card's SM count (:func:`build.sm_count`), so a short prompt still
  spreads over the card.

:func:`flash_attention_plain` (a port of ``repro/kernels/ref.py:12-37``)
is what ``kernels.ops`` runs for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.flash_attention.argtypes = (
        [I, P, P, P, P] + [I] * 6 + [I64] * 9 + [ctypes.c_float, I, I, I, I, P]
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


def kernel_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The path of ``csrc/flash_attention.cu`` that a call on these
    tensors takes, by the rule of its ``launch``: ``"wgmma"`` (bfloat16
    rows 16-byte aligned: ``flash_attention_kernel_wgmma``), ``"cuda
    cores"`` (float32 rows 16-byte aligned) or ``"cuda cores, element
    loads"``."""
    item = q.element_size()

    def aligned(t):
        return t.data_ptr() % 16 == 0 and all(s * item % 16 == 0 for s in t.stride()[:3])

    vec = q.shape[3] * item % 16 == 0 and all(aligned(t) for t in (q, k, v))
    if not vec:
        return "cuda cores, element loads"
    # the tensor maps step every dimension longer than 1 by a non-zero stride
    stepped = all(n == 1 or st != 0 for t in (q, k, v)
                  for n, st in zip(t.shape[:3], t.stride()[:3]))
    return "wgmma" if q.dtype == torch.bfloat16 and stepped else "cuda cores"


@dataclass(frozen=True)
class WgmmaPlan:
    """How ``launch_wg_dt`` cuts a call on the ``"wgmma"`` path."""

    mode: str        # "rows" or "split"
    warpgroups: int  # warpgroups a block
    rows: int        # query rows a block
    keys: int        # keys a tile
    width: int       # the head-dim template: 64, 128 or 256
    blocks: int      # the grid


def wgmma_plan(B: int, H: int, S: int, T: int, D: int, sms: int) -> WgmmaPlan:
    """The launch rule of ``launch_wg_dt`` in ``csrc/flash_attention.cu``:
    two warpgroups of 64 rows where 128-row blocks fill the card; two on
    the same 64 rows over alternate tiles of 64 keys where the keys span
    more than one (D <= 128); else one.  A tile holds 128 keys where two
    groups of rows share it up to D = 128, else 64."""
    width = 64 if D <= 64 else 128 if D <= 128 else 256

    def blocks(bq):
        return -(-S // bq) * H * B

    if blocks(128) >= sms:
        return WgmmaPlan("rows", 2, 128, 128 if width <= 128 else 64, width, blocks(128))
    if width <= 128 and T > 64:
        return WgmmaPlan("split", 2, 64, 64, width, blocks(64))
    return WgmmaPlan("rows", 1, 64, 64, width, blocks(64))


def block_tiles(plan: WgmmaPlan, q0: int, S: int, T: int, causal: bool,
                window: Optional[int]) -> range:
    """The key tiles (of ``plan.keys`` keys) that the block whose first row
    is ``q0`` loads: from the first its window reaches to its causal
    diagonal, none where no key is left."""
    BK = plan.keys
    q_last = min(q0 + plan.rows, S) - 1
    k_end = min(T, q_last + 1) if causal else T
    k_begin = max(0, q0 - window + 1) if window is not None else 0
    if k_end <= k_begin:
        return range(0)
    kt0 = k_begin // BK
    return range(kt0, kt0 + -(-(k_end - kt0 * BK) // BK))


def group_tiles(plan: WgmmaPlan, q0: int, wg: int, S: int, T: int, causal: bool,
                window: Optional[int]) -> Tuple[range, List[int]]:
    """``(rows, tiles)`` that warpgroup ``wg`` of that block computes: its
    query rows and the key tiles of the block's that meet its rows' keys
    (under ``"split"``, of its parity only)."""
    tiles = block_tiles(plan, q0, S, T, causal, window)
    first = q0 + (64 * wg if plan.mode == "rows" else 0)
    rows = range(first, min(first + 64, S))
    if not rows:
        return rows, []
    end = min(T, rows[-1] + 1) if causal else T
    begin = max(0, first - window + 1) if window is not None else 0
    BK = plan.keys
    own = [u for i, u in enumerate(tiles)
           if (plan.mode != "split" or i % 2 == wg) and u * BK < end and u * BK + BK > begin]
    return rows, own


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
            build.sm_count(q.device), stream,
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
