"""Page migration (demote/promote) as hand-written CUDA gather/scatter kernels.

Counterpart of ``repro/kernels/page_migrate.py``: moving a KV page
between tiers is a frame copy indexed by the page table.

* :func:`page_gather`: ``out[i] = src[frames[i]]`` — collect migrating
  pages into a contiguous staging buffer.
* :func:`page_scatter`: ``dst[frames[i]] = pages[i]`` — land incoming
  pages in their target frames, in place; returns ``dst``.

Frame indices must lie in ``[0, F)``; the kernels do not check them.
They copy in 16-byte vectors, so a frame's size and the base address of
every tensor must be multiples of 16 bytes; the wrappers raise otherwise.
Both launch ``csrc/page_migrate.cu`` on the current CUDA stream and do
not synchronise, so copies issued in program order (the staged flush's
gathers before its scatters) run in that order.  Each wrapper counts its
launches in a plain integer attribute, ``page_gather.launches``.  The
plain PyTorch versions, :func:`page_gather_plain` and
:func:`page_scatter_plain`, are what ``kernels.ops`` runs for a CPU
tensor.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def _bind(lib: ctypes.CDLL) -> None:
    for fn in (lib.page_gather, lib.page_scatter):
        fn.argtypes = [_P, _P, _P, _I64, _I64, _P]
        fn.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return build.library("page_migrate", _bind)


def _check_aligned(what: str, store: torch.Tensor) -> None:
    """The kernels copy 16-byte vectors: frame size and base must align."""
    frame = _frame_bytes(store)
    if frame % 16 or store.data_ptr() % 16:
        raise ValueError(f"{what}: frames of {frame} B or a base address are "
                         "not 16-byte aligned")


def _check_frames(store: torch.Tensor, frames: torch.Tensor, what: str) -> None:
    if not store.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, got {store.device}")
    if frames.device != store.device:
        raise ValueError(f"{what}: frames on {frames.device}, store on {store.device}")
    if frames.dtype != torch.int32 or frames.dim() != 1:
        raise ValueError(f"{what}: frames must be a 1-D int32 tensor")
    if not store.is_contiguous():
        raise ValueError(f"{what}: the frame store must be contiguous")


def _frame_bytes(store: torch.Tensor) -> int:
    return store[0].numel() * store.element_size() if store.shape[0] else 0


def page_gather(src: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """``out[i] = src[frames[i]]`` on the card; ``src`` is ``(F, ...)``."""
    _check_aligned("page_gather", src)
    _check_frames(src, frames, "page_gather")
    frames = frames.contiguous()
    out = torch.empty((frames.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    if out.numel() == 0:  # nothing to launch, so nothing to count
        return out
    lib = _lib()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        code = lib.page_gather(src.data_ptr(), frames.data_ptr(), out.data_ptr(),
                               frames.shape[0], _frame_bytes(src), stream)
    build.check(lib, code, "page_gather")
    page_gather.launches += 1
    return out


def page_scatter(dst: torch.Tensor, frames: torch.Tensor,
                 pages: torch.Tensor) -> torch.Tensor:
    """``dst[frames[i]] = pages[i]`` on the card, in place; returns ``dst``.

    Duplicate target frames are allowed only with identical payloads
    (the staged flush pads its batches with trash-frame copies).
    """
    _check_aligned("page_scatter", dst)
    _check_frames(dst, frames, "page_scatter")
    if pages.device != dst.device or pages.dtype != dst.dtype:
        raise ValueError("page_scatter: pages must match dst's device and dtype")
    if tuple(pages.shape) != (frames.shape[0],) + tuple(dst.shape[1:]):
        raise ValueError(
            f"page_scatter: pages {tuple(pages.shape)} do not fit "
            f"{frames.shape[0]} frames of {tuple(dst.shape[1:])}"
        )
    frames = frames.contiguous()
    pages = pages.contiguous()
    _check_aligned("page_scatter", pages)
    if pages.numel() == 0:  # nothing to launch, so nothing to count
        return dst
    lib = _lib()
    with torch.cuda.device(dst.device):
        stream = torch.cuda.current_stream(dst.device).cuda_stream
        code = lib.page_scatter(dst.data_ptr(), frames.data_ptr(), pages.data_ptr(),
                                frames.shape[0], _frame_bytes(dst), stream)
    build.check(lib, code, "page_scatter")
    page_scatter.launches += 1
    return dst


page_gather.launches = 0
page_scatter.launches = 0


def page_gather_plain(src: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`page_gather`."""
    return src.index_select(0, frames.long())


def page_scatter_plain(dst: torch.Tensor, frames: torch.Tensor,
                       pages: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`page_scatter` (in place)."""
    return dst.index_copy_(0, frames.long(), pages)
