"""Mixture-of-Experts layer: top-k router, routed + optional shared experts.

Counterpart of ``repro/models/moe.py``.  Routing goes through
``kernels.ops.router_topk`` (softmax, top-k, renormalise: the CUDA
kernel for a CUDA tensor).  Dispatch keeps the JAX package's capacity
semantics exactly: each expert takes at most
``C = max(1, int(capacity_factor * T * K / E))`` assignments, ``T``
counting every row of ``x`` (padded decode lanes too), first come first
served in token order; overflowed assignments land in a discarded slot
``E * C`` and contribute nothing.  The expert SwiGLU runs batched over
all ``E`` experts as einsums, and the router, expert and shared
products stay plain ``torch`` matmuls.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import nn
from repro_torch.models.ffn import ffn_fwd, init_ffn
from repro_torch.models.nn import Params


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0  # total shared-expert width
    capacity_factor: float = 1.25


def init_moe(generator: torch.Generator, d_model: int, cfg: MoeConfig,
             dtype=torch.float32, device="cuda") -> Params:
    """The tree of ``repro.models.moe.init_moe``: ``router`` (float32),
    batched expert weights ``wi_gate``/``wi_up`` ``(E, d, F)`` and ``wo``
    ``(E, F, d)``, and ``shared`` when the config has shared experts."""
    E, Fe = cfg.n_experts, cfg.d_ff_expert
    kw = dict(dtype=dtype, device=device)
    std = 1.0 / math.sqrt(d_model)
    p: Params = {
        "router": nn.dense_init(generator, d_model, E, dtype=torch.float32,
                                device=device, std=0.02),
        "wi_gate": nn.normal_init(generator, (E, d_model, Fe), std, **kw),
        "wi_up": nn.normal_init(generator, (E, d_model, Fe), std, **kw),
        "wo": nn.normal_init(generator, (E, Fe, d_model), 1.0 / math.sqrt(Fe), **kw),
    }
    if cfg.n_shared > 0:
        p["shared"] = init_ffn(generator, d_model, cfg.d_ff_shared, "swiglu", **kw)
    return p


def moe_fwd(p: Params, cfg: MoeConfig, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x (B, S, d)`` → ``(y (B, S, d), aux_loss)``."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d)

    logits = nn.dense(p["router"], xt.float())  # (T, E)
    probs, gate_vals, gate_idx = kernel_ops.router_topk(logits.contiguous(), K)
    flat_e = gate_idx.reshape(-1).long()  # (T*K,)

    # Switch-style load-balance auxiliary loss
    me = probs.mean(dim=0)
    # (bincount would wait on the device for its output size)
    counts = torch.zeros(E, dtype=torch.long, device=x.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    ce = counts.float() / (T * K)
    aux = E * torch.sum(me * ce)

    C = max(1, int(cfg.capacity_factor * T * K / E))

    # position within each expert: a stable sort groups the assignments
    # by expert in token order, so rank-in-group is first come first served
    order = torch.argsort(flat_e, stable=True)
    starts = torch.cumsum(counts, dim=0) - counts
    pos_sorted = torch.arange(T * K, device=x.device) - starts[flat_e[order]]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    slot = torch.where(pos < C, flat_e * C + pos, E * C)  # (T*K,)

    # scatter into (E, C, d); overflow rows all add into slot E*C, so the
    # write must accumulate duplicates (a plain indexed += drops them)
    xe = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    xe.index_add_(0, slot, xt.repeat_interleave(K, dim=0))
    xe = xe[: E * C].reshape(E, C, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", xe, p["wi_gate"])) * torch.einsum(
        "ecd,edf->ecf", xe, p["wi_up"])
    ye = torch.einsum("ecf,efd->ecd", h, p["wo"])  # (E, C, d)

    ye_flat = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))], dim=0)
    yk = ye_flat[slot].reshape(T, K, d)
    y = torch.sum(yk * gate_vals[..., None].to(yk.dtype), dim=1)
    if "shared" in p:
        y = y + ffn_fwd(p["shared"], xt, "swiglu")
    return y.reshape(B, S, d), aux
