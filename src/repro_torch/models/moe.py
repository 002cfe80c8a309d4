"""Mixture-of-Experts layer: top-k router, routed + optional shared experts.

Counterpart of ``repro/models/moe.py``.  The routing stage (router
product, softmax, top-k, capacity slots, aux loss) is one call of
``kernels.ops.moe_route``, the gather into expert slots
``kernels.ops.moe_dispatch`` and the gated sum ``kernels.ops.moe_combine``:
three CUDA kernels for a CUDA tensor, their plain versions for a CPU
one.  Dispatch keeps the JAX package's capacity semantics exactly: each
expert takes at most ``C = max(1, int(capacity_factor * T * K / E))``
assignments (or the caller's ``capacity``), ``T`` counting every row of
``x`` (padded decode lanes too), first come first served in token
order; overflowed assignments land in a discarded slot ``E * C`` and
contribute nothing.  The expert SwiGLU is ``kernels.ops.moe_experts``
over the filled slots alone (on the card a CUDA kernel that reads the
counts there, float32 or bfloat16) wherever no gradient is needed.
Autograd and the expert-parallel layout (DTensors) still run it batched
over all ``E * C`` slots as einsums: the kernel's backward is not yet
ported.  The shared products stay plain ``torch`` matmuls.

Under autograd the three calls carry the gradient of JAX's ``moe_fwd``
(router, experts, input, shared FFN): the route's through its gates and
aux loss, the dispatch's as the sum of each token's slot gradients, the
combine's through the ``moe_combine_bwd`` kernel (``kernels/ops.py``).
The expert weights and activations may be float32 or bfloat16 (the
router stays float32, as JAX's); the MoE kernels take either.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import nn
from repro_torch.models.ffn import ffn_fwd, init_ffn
from repro_torch.models.layout import replicated
from repro_torch.models.nn import Params
from repro_torch.spans import span


# Expert-parallel layout axis.  On DTensors the expert compute (E, C, ·)
# is laid out with its expert dim sharded on this mesh axis, the port's
# form of JAX's sharding constraint; without it the token → slot gather
# leaves the whole expert compute replicated on every model rank.  The
# dry-run sets it to "model"; a plain tensor passes ``_ep`` unchanged.
EP_AXIS: Optional[str] = None


def _ep(x: torch.Tensor) -> torch.Tensor:
    """``x`` with dim 0 sharded on ``EP_AXIS``, replicated on every other
    mesh dim (JAX's ``P(EP_AXIS, None, ...)``); a no-op on a plain tensor."""
    if EP_AXIS is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    layout = [Shard(0) if name == EP_AXIS else Replicate() for name in mesh.mesh_dim_names]
    return x.redistribute(mesh, layout)


def _filled_only(xe: torch.Tensor, p: Params) -> bool:
    """The expert products over the filled slots alone
    (``kernel_ops.moe_experts``) take plain tensors of one dtype, float32
    or bfloat16, with no gradient to carry.  Autograd and the
    expert-parallel layout (DTensors) keep the einsums over every slot:
    the filled-slot path has no backward yet."""
    ts = (xe, p["wi_gate"], p["wi_up"], p["wo"])
    return (xe.dtype in (torch.float32, torch.bfloat16)
            and all(t.dtype == xe.dtype and not isinstance(t, DTensor) for t in ts)
            and not kernel_ops._grad(*ts))


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0  # total shared-expert width
    capacity_factor: float = 1.25
    # read by no code in either package; kept so configs equal field for field
    router_noise: float = 0.0


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


def moe_fwd(p: Params, cfg: MoeConfig, x: torch.Tensor,
            capacity: Optional[int] = None, impl: str = "auto"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x (B, S, d)`` → ``(y (B, S, d), aux_loss)``; ``capacity``
    overrides the slots an expert takes; ``impl`` picks the kernels or
    their plain versions (``kernels.ops``)."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d).contiguous()
    if "b" in p["router"]:
        raise ValueError("moe_fwd: the router has no bias (nn.dense_init's default)")

    C = capacity if capacity is not None else max(
        1, int(cfg.capacity_factor * T * K / E))
    # float32 activations against the router weight in float32, as JAX's
    # promotion of a float32 x and a bfloat16 w (repro/models/moe.py:90)
    with span("moe.route"):
        r = replicated(kernel_ops.moe_route, xt.float(), p["router"]["w"].float(), K, C,
                        impl=impl)
    with span("moe.dispatch"):
        xe = _ep(replicated(kernel_ops.moe_dispatch, xt, r.src, E, C, impl=impl,
                             slot=r.slot))  # (E, C, d)

    with span("moe.experts"):
        if _filled_only(xe, p):
            ye = kernel_ops.moe_experts(xe, r.counts, p["wi_gate"], p["wi_up"], p["wo"],
                                        assignments=T * K, impl=impl)
        else:
            h = nn.silu(torch.einsum("ecd,edf->ecf", xe, p["wi_gate"])) * torch.einsum(
                "ecd,edf->ecf", xe, p["wi_up"])
            ye = _ep(torch.einsum("ecf,efd->ecd", _ep(h), p["wo"])).contiguous()  # (E, C, d)

    with span("moe.combine"):
        y = replicated(kernel_ops.moe_combine, ye, r.slot, r.vals, impl=impl, like=xt)
        if "shared" in p:
            y = y + ffn_fwd(p["shared"], xt, "swiglu")
    return y.reshape(B, S, d), r.aux
