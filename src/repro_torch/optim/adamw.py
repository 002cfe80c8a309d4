"""AdamW with global-norm clipping and a cosine schedule (counterpart of
``repro/optim/adamw.py``).

The state is float32 moments ``m`` and ``v`` and, with ``master=True``,
a float32 master copy of the parameters, kept even when the parameters
are float32 themselves, as in JAX.  Trees are the port's dicts and lists
of tensors, walked in JAX's flatten order (``nn.tree_leaves``).

Each leaf is updated in flat chunks of at most :data:`CHUNK` elements, so
the temporaries of an update stay small beside a 3 GB expert leaf.  A
state leaf that lies in host memory while its parameter is on the card
(``optim.offload.apply_placement``) is streamed to the card chunk by
chunk, updated there and written back with non-blocking copies on the
current stream; the step synchronises before it returns.  Either way
the arithmetic is the same, so the result is the same bit for bit.

``update(..., inplace=True)`` writes the new values into the given
parameters and state (the port's counterpart of JAX's buffer donation,
which the training loop uses to hold one copy of the state);
``inplace=False`` leaves them untouched and returns new trees.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import nn

Params = Any
CHUNK = 1 << 24  # elements a chunk of an update: 64 MB of float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    master: bool = True  # fp32 master weights when params are low-precision


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32, on the parameters' device
    m: Params
    v: Params
    master: Optional[Params]


def init(params: Params, cfg: AdamWConfig) -> AdamWState:
    leaves = nn.tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    zeros = nn.tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), params)
    master = (nn.tree_map(lambda x: x.detach().to(torch.float32, copy=True), params)
              if cfg.master else None)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), m=zeros,
                      v=nn.tree_map(torch.clone, zeros), master=master)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, summed in JAX's leaf
    order."""
    total = None
    for x in nn.tree_leaves(tree):
        sq = x.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(grads: Params, state: AdamWState, params: Params, cfg: AdamWConfig,
           lr_scale=1.0, inplace: bool = False, grad_norm: Optional[torch.Tensor] = None
           ) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step → ``(new_params, new_state, metrics)``
    (``repro/optim/adamw.py:55-91``).  ``grad_norm``, when the caller has
    it, saves computing it again."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    device = gnorm.device
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)

    step = state.step.to(device) + 1
    stepf = step.float()
    f32 = dict(dtype=torch.float32, device=device)
    b1c = 1.0 - torch.tensor(cfg.b1, **f32) ** stepf
    b2c = 1.0 - torch.tensor(cfg.b2, **f32) ** stepf
    lr = cfg.lr * torch.as_tensor(lr_scale, **f32)

    if not inplace:
        params = nn.tree_map(_copy, params)
        state = AdamWState(step=state.step, m=nn.tree_map(_copy, state.m),
                           v=nn.tree_map(_copy, state.v),
                           master=(nn.tree_map(_copy, state.master)
                                   if state.master is not None else None))
    p_leaves = nn.tree_leaves(params)
    g_leaves = nn.tree_leaves(grads)
    m_leaves = nn.tree_leaves(state.m)
    v_leaves = nn.tree_leaves(state.v)
    w_leaves = nn.tree_leaves(state.master) if cfg.master else [None] * len(p_leaves)
    hp = HyperParams(cfg, scale, b1c, b2c, lr)
    streamed = False
    for p, g, m, v, w in zip(p_leaves, g_leaves, m_leaves, v_leaves, w_leaves):
        streamed |= _update_leaf(p, g, m, v, w, hp)
    if streamed:
        torch.cuda.current_stream(device).synchronize()
    new_state = AdamWState(step=step.to(state.step.device), m=state.m, v=state.v,
                           master=state.master if cfg.master else None)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


class HyperParams(NamedTuple):
    cfg: AdamWConfig
    scale: Optional[torch.Tensor]  # the clip factor, or None
    b1c: torch.Tensor
    b2c: torch.Tensor
    lr: torch.Tensor


def _copy(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x, pin_memory=x.is_pinned())
    return out.copy_(x)


def _update_dtensor_leaf(p, g, m, v, w, hp: HyperParams) -> None:
    """A DTensor leaf (the dry-run): the gradient and parameter are laid
    out as the state (ZeRO-1 shards it further over ``data``), the update
    runs there, and the parameter takes the new value in its own layout."""
    mesh, layout = m.device_mesh, m.placements
    g = g.redistribute(mesh, layout)
    base = w if w is not None else p.redistribute(mesh, layout)
    new = base.detach().clone() if w is None else base
    _update_chunk(new, g, m, v, *([w] if w is not None else []), hp=hp)
    p.copy_(new.redistribute(p.device_mesh, p.placements))


def _update_leaf(p, g, m, v, w, hp: HyperParams) -> bool:
    """Update one leaf in place (``p``, ``m``, ``v`` and the master copy
    ``w`` or None) in flat chunks; a state leaf in host memory is
    streamed to ``p``'s device.  Returns whether one was."""
    if isinstance(p, DTensor):
        _update_dtensor_leaf(p, g, m, v, w, hp)
        return False
    dev = p.device
    state = [t for t in (m, v, w) if t is not None]
    host = [t.device != dev for t in state]
    n = p.numel()
    flat = [p.view(-1), g.reshape(-1)] + [t.view(-1) for t in state]
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        pc, gc, *sc = (t[lo:hi] for t in flat)
        work = [s.to(dev, non_blocking=True) if h else s for s, h in zip(sc, host)]
        _update_chunk(pc, gc, *work, hp=hp)
        for s, h, wk in zip(sc, host, work):
            if h:
                s.copy_(wk, non_blocking=True)
    return any(host)


def _update_chunk(p, g, m, v, *w, hp: HyperParams) -> None:
    cfg = hp.cfg
    g32 = g.float()
    if hp.scale is not None:
        g32 = g32 * hp.scale
    m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
    v.mul_(cfg.b2).add_(g32 * (1 - cfg.b2) * g32)
    base = w[0] if w else p.float()
    mh = m / hp.b1c
    vh = v / hp.b2c
    new = base - hp.lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * base)
    if w:
        w[0].copy_(new)
    p.copy_(new)


# --------------------------------------------------------------------- #
# schedules
# --------------------------------------------------------------------- #
def cosine_schedule(warmup: int, total: int, min_frac: float = 0.1) -> Callable:
    """Linear warmup to 1, then a cosine down to ``min_frac`` at ``total``;
    takes a step (an int or a tensor) → a float32 tensor."""
    def fn(step):
        step = torch.as_tensor(step).float()
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return warm * cos

    return fn
