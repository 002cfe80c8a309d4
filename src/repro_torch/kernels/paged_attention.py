"""Paged decode attention: a hand-written CUDA kernel and its plain version.

Counterpart of ``repro/kernels/paged_attention.py``.  One new token per
sequence attends over that sequence's KV pages, selected by a ``(B, MP)``
block table of frame ids into ``k_pages``/``v_pages`` of shape
``(F, Hkv, P, D)``.  Two masking modes:

* **length mode** (``lengths``): token ``ip·P + j`` is valid iff it is
  ``< lengths[b]``.
* **position mode** (``page_pos`` + ``q_pos``): each entry carries the
  absolute position of its page's first token; valid iff
  ``page_pos + j <= q_pos`` (and ``> q_pos - window`` with a window).
  Pad entries use :data:`PAD_PAGE_POS` and mask out.

:func:`paged_attention` launches ``csrc/paged_attention.cu`` on the
current CUDA stream and counts its launches in
``paged_attention.launches``.  The store may be a per-layer view
``store[:, li]`` of an ``(F, L, Hkv, P, D)`` store: the kernel takes the
frame stride, so the view is read in place and never copied; only its
inner ``(Hkv, P, D)`` block has to be contiguous.
:func:`paged_attention_plain` (a port of ``repro/kernels/ref.py:40-78``)
is what ``kernels.ops`` runs for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

# Pad entries in position-mode block tables use this page start: every
# slot position exceeds any reachable q_pos, so the page masks out.
PAD_PAGE_POS = 1 << 30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.paged_attention.argtypes = (
        [I] + [P] * 8 + [I] * 6 + [I64, I64, ctypes.c_float, I, I, P]
    )
    lib.paged_attention.restype = I


def _check_mode(lengths, page_pos, q_pos, window) -> bool:
    """Validate the mask arguments; True for position mode."""
    if page_pos is not None:
        if q_pos is None:
            raise ValueError("position mode needs both page_pos and q_pos")
        return True
    if lengths is None:
        raise ValueError("length mode needs lengths")
    if window is not None:
        raise ValueError("window masking needs position mode (page_pos/q_pos)")
    return False


def _i32(t: Optional[torch.Tensor], device: torch.device, what: str):
    if t is None:
        return None
    if t.device != device or t.dtype != torch.int32:
        raise ValueError(f"paged_attention: {what} must be int32 on {device}")
    return t.contiguous()


def paged_attention(
    q: torch.Tensor,  # (B, H, D)
    k_pages: torch.Tensor,  # (F, Hkv, P, D), inner block contiguous
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # (B, MP) int32
    lengths: Optional[torch.Tensor] = None,  # (B,) int32 (length mode)
    scale: Optional[float] = None,
    page_pos: Optional[torch.Tensor] = None,  # (B, MP) int32 (position mode)
    q_pos: Optional[torch.Tensor] = None,  # (B,) int32 (position mode)
    window: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention over pages on the card → ``(B, H, D)`` in q's type.

    Block-table entries must lie in ``[0, F)``: like the TPU kernel, the
    kernel reads the frames it is given without checking them (a check
    would cost a device→host sync per call).
    """
    pos_mode = _check_mode(lengths, page_pos, q_pos, window)
    if not q.is_cuda:
        raise ValueError(f"paged_attention: the CUDA kernel needs a CUDA tensor, got {q.device}")
    B, H, D = q.shape
    F, Hkv, P, Dk = k_pages.shape
    if Dk != D or tuple(v_pages.shape) != tuple(k_pages.shape) or H % Hkv:
        raise ValueError(
            f"paged_attention: q {tuple(q.shape)} does not fit pages "
            f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}"
        )
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("paged_attention: q, k_pages and v_pages must all be "
                         "float32 or all bfloat16")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on {q.device}")
        if t.stride()[1:] != (P * D, D, 1):
            raise ValueError(
                f"paged_attention: {name} needs a contiguous (Hkv, P, D) block "
                f"per frame, got strides {t.stride()}"
            )
    MP = block_table.shape[1]
    if tuple(block_table.shape) != (B, MP):
        raise ValueError("paged_attention: block_table must be (B, MP)")
    bt = _i32(block_table, q.device, "block_table")
    lengths = _i32(lengths, q.device, "lengths")
    page_pos = _i32(page_pos, q.device, "page_pos")
    q_pos = _i32(q_pos, q.device, "q_pos")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q = q.contiguous()
    out = torch.empty_like(q)
    lib = build.library("paged_attention", _bind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.paged_attention(
            _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            bt.data_ptr(),
            None if pos_mode else lengths.data_ptr(),
            page_pos.data_ptr() if pos_mode else None,
            q_pos.data_ptr() if pos_mode else None,
            out.data_ptr(), B, MP, Hkv, H // Hkv, P, D,
            k_pages.stride(0), v_pages.stride(0), float(scale),
            int(window is not None), int(window or 0), stream,
        )
    build.check(lib, code, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    page_pos: Optional[torch.Tensor] = None,
    q_pos: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`paged_attention` (gather + softmax)."""
    pos_mode = _check_mode(lengths, page_pos, q_pos, window)
    B, H, D = q.shape
    F, Hkv, P, _ = k_pages.shape
    MP = block_table.shape[1]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    bt = block_table.long()
    # gather per sequence: (B, MP, Hkv, P, D) → (B, Hkv, MP*P, D)
    kg = k_pages[bt].movedim(2, 1).reshape(B, Hkv, MP * P, D)
    vg = v_pages[bt].movedim(2, 1).reshape(B, Hkv, MP * P, D)
    qf = q.reshape(B, Hkv, G, D).float() * scale
    s = torch.einsum("bhgd,bhtd->bhgt", qf, kg.float())
    if pos_mode:
        slot = torch.arange(P, device=q.device)
        abs_pos = (page_pos.long()[:, :, None] + slot).reshape(B, MP * P)
        qp = q_pos.long()[:, None]
        valid = abs_pos <= qp
        if window is not None:
            valid &= abs_pos > qp - window
    else:
        t_pos = torch.arange(MP * P, device=q.device)[None, :]
        valid = t_pos < lengths.long()[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    o = torch.einsum("bhgt,bhtd->bhgd", p, vg.float())
    return o.reshape(B, H, D).to(q.dtype)
