"""Page migration (demote/promote) as hand-written CUDA gather/scatter kernels.

Counterpart of ``repro/kernels/page_migrate.py``: moving a KV page
between tiers is a frame copy indexed by the page table.

* :func:`page_gather`: ``out[i] = src[frames[i]]`` — collect migrating
  pages into a contiguous staging buffer.
* :func:`page_scatter`: ``dst[frames[i]] = pages[i]`` — land incoming
  pages in their target frames, in place; returns ``dst``.

Both take one contiguous ``(F, ...)`` store or a tuple of same-shape,
same-dtype stores (the cache's K and V), copied in one launch; the
staging is then ``(S, n, ...)``.  ``frames`` is a 1-D int32 **CPU**
tensor: the launcher reads it on the host and passes the indices to the
kernel by value, the counterpart of the TPU kernel's scalar prefetch.
A CUDA ``frames`` tensor is refused, since reading it would hide a
device→host sync.  Frame indices must lie in ``[0, F)`` (checked on the
host).  The kernels move 16-byte aligned bulk copies, so a frame's size
and the base address of every tensor must be multiples of 16 bytes; the
wrappers raise otherwise.  A list longer than :data:`MAX_PAIRS` is
launched in chunks of it, each chunk one launch.

Both launch ``csrc/page_migrate.cu`` on the current CUDA stream and do
not synchronise, so copies issued in program order (the staged flush's
gather before its scatter) run in that order.  Each wrapper counts its
launches in a plain integer attribute, ``page_gather.launches``.  The
plain PyTorch versions, :func:`page_gather_plain` and
:func:`page_scatter_plain`, take the same arguments (``frames`` on any
device) and are what ``kernels.ops`` runs for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple, Union

import torch

from repro_torch.kernels import build

#: frame indices one launch carries by value (``kMaxPairs`` in the source)
MAX_PAIRS = 256
#: stores one launch copies (``kMaxStores`` in the source)
MAX_STORES = 2

Stores = Union[torch.Tensor, Sequence[torch.Tensor]]

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_I = ctypes.c_int
_I64 = ctypes.c_int64


def _bind(lib: ctypes.CDLL) -> None:
    for fn in (lib.page_gather, lib.page_scatter):
        fn.argtypes = [_PP, _PP, _I, _P, _I, _I64, _I, _P]
        fn.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return build.library("page_migrate", _bind)


def _as_tuple(x: Stores, what: str) -> Tuple[torch.Tensor, ...]:
    stores = (x,) if isinstance(x, torch.Tensor) else tuple(x)
    if not 1 <= len(stores) <= MAX_STORES:
        raise ValueError(f"{what}: takes 1 to {MAX_STORES} stores, got {len(stores)}")
    return stores


def _frame_bytes(store: torch.Tensor) -> int:
    return store[0].numel() * store.element_size() if store.shape[0] else 0


def _check_aligned(what: str, t: torch.Tensor) -> None:
    """Bulk copies move 16-byte multiples: frame size and base must align."""
    frame = _frame_bytes(t)
    if frame % 16 or t.data_ptr() % 16:
        raise ValueError(f"{what}: frames of {frame} B or a base address are "
                         "not 16-byte aligned")


def _check_stores(stores: Tuple[torch.Tensor, ...], what: str) -> None:
    first = stores[0]
    for s in stores:
        _check_aligned(what, s)
        if (s.shape != first.shape or s.dtype != first.dtype
                or s.device != first.device):
            raise ValueError(f"{what}: stores differ in shape, dtype or device: "
                             f"{tuple(first.shape)} {first.dtype} {first.device} vs "
                             f"{tuple(s.shape)} {s.dtype} {s.device}")
        if not s.is_contiguous():
            raise ValueError(f"{what}: a frame store must be contiguous")
    if not first.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel needs CUDA tensors, got {first.device}")


def _check_frames(frames: torch.Tensor, n_frames: int, what: str) -> None:
    if frames.device.type != "cpu":
        raise ValueError(f"{what}: frames must be a CPU tensor (read on the host "
                         f"and passed by value), got {frames.device}")
    if frames.dtype != torch.int32 or frames.dim() != 1:
        raise ValueError(f"{what}: frames must be a 1-D int32 tensor")
    if frames.numel() and (int(frames.min()) < 0 or int(frames.max()) >= n_frames):
        raise ValueError(f"{what}: frame indices outside [0, {n_frames})")


def _launch(fn, stores, staging: torch.Tensor, frames: torch.Tensor) -> None:
    """``fn``'s kernel, one launch per :data:`MAX_PAIRS` frames;
    ``staging`` is ``(S, n, ...)``."""
    n, S = frames.shape[0], len(stores)
    fb = _frame_bytes(stores[0])
    frames = frames.contiguous()
    lib = _lib()
    dev = stores[0].device
    sms = build.sm_count(dev)
    store_ptrs = (_P * MAX_STORES)(*[s.data_ptr() for s in stores])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for off in range(0, n, MAX_PAIRS):
            m = min(MAX_PAIRS, n - off)
            staged = (_P * MAX_STORES)(*[staging.data_ptr() + (s * n + off) * fb
                                        for s in range(S)])
            code = getattr(lib, fn.__name__)(store_ptrs, staged, S,
                                             frames.data_ptr() + 4 * off, m, fb, sms,
                                             stream)
            build.check(lib, code, fn.__name__)
            fn.launches += 1


def page_gather(src: Stores, frames: torch.Tensor) -> torch.Tensor:
    """``out[i] = src[frames[i]]`` on the card: ``(n, ...)`` for one
    ``(F, ...)`` store, ``(S, n, ...)`` for a tuple of ``S`` stores."""
    stores = _as_tuple(src, "page_gather")
    _check_frames(frames, stores[0].shape[0], "page_gather")
    _check_stores(stores, "page_gather")
    n = frames.shape[0]
    out = torch.empty((len(stores), n) + tuple(stores[0].shape[1:]),
                      dtype=stores[0].dtype, device=stores[0].device)
    if out.numel():  # nothing to launch, so nothing to count
        _launch(page_gather, stores, out, frames)
    return out[0] if isinstance(src, torch.Tensor) else out


def page_scatter(dst: Stores, frames: torch.Tensor, pages: torch.Tensor) -> Stores:
    """``dst[frames[i]] = pages[i]`` on the card, in place; returns ``dst``.

    ``pages`` is ``(n, ...)`` for one store, ``(S, n, ...)`` for a tuple.
    Duplicate target frames are allowed only with identical payloads.
    """
    stores = _as_tuple(dst, "page_scatter")
    _check_frames(frames, stores[0].shape[0], "page_scatter")
    _check_stores(stores, "page_scatter")
    first = stores[0]
    lead = (frames.shape[0],) if isinstance(dst, torch.Tensor) else (
        len(stores), frames.shape[0])
    if pages.device != first.device or pages.dtype != first.dtype:
        raise ValueError("page_scatter: pages must match dst's device and dtype")
    if tuple(pages.shape) != lead + tuple(first.shape[1:]):
        raise ValueError(
            f"page_scatter: pages {tuple(pages.shape)} do not fit "
            f"{lead} frames of {tuple(first.shape[1:])}")
    pages = pages.contiguous()
    _check_aligned("page_scatter", pages)
    if pages.numel():  # nothing to launch, so nothing to count
        _launch(page_scatter, stores, pages, frames)
    return dst


page_gather.launches = 0
page_scatter.launches = 0


def page_gather_plain(src: Stores, frames: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`page_gather`: ``index_select`` per store."""
    stores = _as_tuple(src, "page_gather")
    idx = frames.to(device=stores[0].device, dtype=torch.long)
    if isinstance(src, torch.Tensor):
        return src.index_select(0, idx)
    return torch.stack([s.index_select(0, idx) for s in stores])


def page_scatter_plain(dst: Stores, frames: torch.Tensor,
                       pages: torch.Tensor) -> Stores:
    """Plain PyTorch version of :func:`page_scatter` (in place):
    ``index_copy_`` per store."""
    stores = _as_tuple(dst, "page_scatter")
    idx = frames.to(device=stores[0].device, dtype=torch.long)
    if isinstance(dst, torch.Tensor):
        return dst.index_copy_(0, idx, pages)
    for s, p in zip(stores, pages):
        s.index_copy_(0, idx, p)
    return dst
