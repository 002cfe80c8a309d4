"""Public entry points over the port's kernels, under the JAX package's names.

Counterpart of ``repro/kernels/ops.py``.  Dispatch is on the tensor's
device (``impl="auto"``): a CUDA tensor launches the hand-written Hopper
kernel, a CPU tensor takes the plain PyTorch version.  There is no
fallback: a kernel that fails to build or launch raises.
``impl="kernel"`` insists on the kernel (and raises for a CPU tensor);
``impl="ref"`` runs the plain version on any device, which is how the
chip smoke test compares the two on the card.

The MoE entry points carry a gradient when an input asks for one: they
run through ``torch.autograd.Function``s whose forward and backward take
the same side (the route's backward is torch ops; the combine's is the
``moe_combine_bwd`` kernel or its plain version; the dispatch's is the
combine with unit gates).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_dispatch as _md
from repro_torch.kernels import page_migrate as _pm
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import router_topk as _rt

#: the kernel wrappers whose ``launches`` counts a run can read
KERNELS = {
    "paged_attention": _pa.paged_attention,
    "page_gather": _pm.page_gather,
    "page_scatter": _pm.page_scatter,
    "router_topk": _rt.router_topk,
    "flash_attention": _fa.flash_attention,
    "moe_route": _rt.moe_route,
    "moe_dispatch": _md.moe_dispatch,
    "moe_combine": _md.moe_combine,
    "moe_combine_bwd": _md.moe_combine_bwd,
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


def flash_attention(q, k, v, causal=True, window=None, scale=None, impl="auto"):
    fn = _fa.flash_attention if _pick(impl, q) == "kernel" else _fa.flash_attention_plain
    return fn(q, k, v, causal=causal, window=window, scale=scale)


def paged_attention(q, k_pages, v_pages, block_table, lengths=None, scale=None,
                    page_pos=None, q_pos=None, window=None, impl="auto"):
    fn = (_pa.paged_attention if _pick(impl, q) == "kernel"
          else _pa.paged_attention_plain)
    return fn(q, k_pages, v_pages, block_table, lengths, scale=scale,
              page_pos=page_pos, q_pos=q_pos, window=window)


def page_gather(src, frames, impl="auto"):
    """``src`` is one ``(F, ...)`` store or a tuple of them; ``frames`` a
    1-D int32 CPU tensor (the kernel takes the indices by value)."""
    first = src if isinstance(src, torch.Tensor) else src[0]
    if _pick(impl, first) == "kernel":
        return _pm.page_gather(src, frames)
    return _pm.page_gather_plain(src, frames)


def page_scatter(dst, frames, pages, impl="auto"):
    """In place on ``dst`` (a store or a tuple of them); returns it."""
    first = dst if isinstance(dst, torch.Tensor) else dst[0]
    if _pick(impl, first) == "kernel":
        return _pm.page_scatter(dst, frames, pages)
    return _pm.page_scatter_plain(dst, frames, pages)


def router_topk(logits, k, impl="auto"):
    """→ ``(probs, vals, idx)``."""
    fn = _rt.router_topk if _pick(impl, logits) == "kernel" else _rt.router_topk_plain
    return fn(logits, k)


def _grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def moe_route(x, w, k, capacity, impl="auto"):
    """The MoE routing stage of ``x (T, d)`` through the router weight
    ``w (d, E)`` at ``capacity`` slots an expert → ``router_topk.Route``;
    ``vals`` and ``aux`` carry the gradient of ``x`` and ``w``."""
    kernel = _pick(impl, x) == "kernel"
    if _grad(x, w):
        return _rt.Route(*_rt.RouteFn.apply(x, w, k, capacity, kernel))
    return (_rt.moe_route if kernel else _rt.moe_route_plain)(x, w, k, capacity)


def moe_dispatch(x, src, n_experts, capacity, impl="auto", slot=None):
    """→ ``xe (E, C, d)``: slot s holds row ``src[s]`` of ``x``, or zeros.
    The gradient of ``x`` needs the route's ``slot``."""
    kernel = _pick(impl, x) == "kernel"
    if _grad(x):
        if slot is None:
            raise ValueError("moe_dispatch: the gradient of x needs the route's slot")
        return _md.Dispatch.apply(x, src, slot, n_experts, capacity, kernel)
    fn = _md.moe_dispatch if kernel else _md.moe_dispatch_plain
    return fn(x, src, n_experts, capacity)


def moe_combine(ye, slot, vals, impl="auto"):
    """→ ``y (T, d)``, each token's expert rows weighted by its gates."""
    kernel = _pick(impl, ye) == "kernel"
    if _grad(ye, vals):
        return _md.Combine.apply(ye, slot, vals, kernel)
    return (_md.moe_combine if kernel else _md.moe_combine_plain)(ye, slot, vals)


def moe_combine_bwd(dy, ye, slot, vals, impl="auto"):
    """The combine's gradient → ``(dye (E, C, d), dvals (T, k))``."""
    fn = (_md.moe_combine_bwd if _pick(impl, ye) == "kernel"
          else _md.moe_combine_bwd_plain)
    return fn(dy, ye, slot, vals)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
