"""Public entry points over the port's kernels, under the JAX package's names.

Counterpart of ``repro/kernels/ops.py``.  Dispatch is on the tensor's
device (``impl="auto"``): a CUDA tensor launches the hand-written Hopper
kernel, a CPU tensor takes the plain PyTorch version.  There is no
fallback: a kernel that fails to build or launch raises.
``impl="kernel"`` insists on the kernel (and raises for a CPU tensor);
``impl="ref"`` runs the plain version on any device, which is how the
chip smoke test compares the two on the card.

``flash_attention`` and ``router_topk`` are still to be ported (ROADMAP
Queue 2).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import page_migrate as _pm
from repro_torch.kernels import paged_attention as _pa

#: the kernel wrappers whose ``launches`` counts a run can read
KERNELS = {
    "paged_attention": _pa.paged_attention,
    "page_gather": _pm.page_gather,
    "page_scatter": _pm.page_scatter,
}


def _pick(impl: str, x: torch.Tensor) -> str:
    if impl == "auto":
        return "kernel" if x.is_cuda else "ref"
    if impl == "kernel" and not x.is_cuda:
        raise ValueError(
            f"impl='kernel' needs a CUDA tensor; the Hopper kernels do not "
            f"run on {x.device}"
        )
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}; choose auto, kernel or ref")
    return impl


def paged_attention(q, k_pages, v_pages, block_table, lengths=None, scale=None,
                    page_pos=None, q_pos=None, window=None, impl="auto"):
    fn = (_pa.paged_attention if _pick(impl, q) == "kernel"
          else _pa.paged_attention_plain)
    return fn(q, k_pages, v_pages, block_table, lengths, scale=scale,
              page_pos=page_pos, q_pos=q_pos, window=window)


def page_gather(src, frames, impl="auto"):
    if _pick(impl, src) == "kernel":
        return _pm.page_gather(src, frames)
    return _pm.page_gather_plain(src, frames)


def page_scatter(dst, frames, pages, impl="auto"):
    """In place on ``dst``; returns it."""
    if _pick(impl, dst) == "kernel":
        return _pm.page_scatter(dst, frames, pages)
    return _pm.page_scatter_plain(dst, frames, pages)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
