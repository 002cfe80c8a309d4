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
from repro_torch.kernels import moe_experts as _mx
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
    "moe_experts": _mx.moe_experts,
}


#: the kernels by the names of their device functions in a profile
DEVICE_FUNCTIONS = (("paged_attention", "paged_attention_kernel"),
                    ("router_topk", "router_topk_kernel"),
                    ("moe_route", "moe_route_kernel"),
                    ("moe_dispatch", "moe_dispatch_kernel"),
                    ("moe_combine", "moe_combine_kernel"),
                    ("moe_combine_bwd", "moe_combine_bwd_kernel"),
                    ("flash_attention", "flash_attention_kernel"),
                    ("moe_experts", "moe_experts_kernel"),
                    ("page_gather+page_scatter", "page_copy_kernel"))


def kernels_in_place(key_averages, steps: int) -> Dict[str, Dict[str, float]]:
    """The port's own kernels in a profile of ``steps`` steps, from
    ``prof.key_averages()``: launches a step and device µs a launch, by
    kernel, for each that ran."""
    own = {}
    for name, fn in DEVICE_FUNCTIONS:
        # "moe_combine_kernel" is no substring of "moe_combine_bwd_kernel"
        evs = [e for e in key_averages if e.device_type.name == "CUDA" and fn in e.key]
        n = sum(e.count for e in evs)
        if n:
            us = sum(e.self_device_time_total for e in evs)
            own[name] = {"launches_per_step": n / steps, "us_per_launch": us / n}
    return own

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


def moe_experts(xe, counts, wi_gate, wi_up, wo, assignments, impl="auto"):
    """→ ``ye (E, C, d)``, the expert SwiGLU of the filled slots ``r <
    min(counts[e], C)``; the kernel leaves the other rows unwritten, the
    plain version computes them from ``xe``.  ``assignments`` (T·k) plans
    the kernel's launch.  No gradient: ``models.moe.moe_fwd`` keeps the
    einsums where one is needed (their backward is not yet ported)."""
    if _pick(impl, xe) == "kernel":
        return _mx.moe_experts(xe, counts, wi_gate, wi_up, wo, assignments)
    return _mx.moe_experts_plain(xe, counts, wi_gate, wi_up, wo)


def moe_expert_rows() -> Dict[str, int]:
    """The expert rows ``moe_experts`` computed so far (``rows``, read from
    the card: a host sync, never inside a step) and the ``E * C`` slots
    its calls offered (``slots``)."""
    return {"rows": _mx.expert_rows(), "slots": _mx.moe_experts.slots}


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
