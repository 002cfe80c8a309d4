"""TPP-style optimizer-state tiering for training (counterpart of
``repro/optim/offload.py``).

Optimizer moments are cold between their touch points, so they can live
in the slow tier (host memory) and be streamed in for each update.
:func:`plan_offload` is the JAX package's watermark plan, leaf for leaf:
HBM keeps headroom below its budget, and leaves are admitted smallest
first (ties in JAX's flatten order), so bulky embedding and expert
moments demote first and per-layer norms stay fast.

:func:`apply_placement` materialises the plan: on the card each ``SLOW``
leaf moves to pinned host memory, and ``optim.update`` streams it to the
card for its update and back.  On the CPU it is the identity walk, as the
JAX package's is there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core.types import Tier, TppConfig
from repro_torch.models import nn


def _leaf_bytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


@dataclasses.dataclass
class OffloadPlan:
    """Which optimizer-state leaves live on which tier (by path, as
    ``jax.tree_util`` names them, ``"/"``-joined)."""

    placement: Dict[str, Tier]
    hbm_budget_bytes: int
    used_bytes: int

    def fraction_fast(self) -> float:
        total = len(self.placement) or 1
        return sum(1 for t in self.placement.values() if t == Tier.FAST) / total


def plan_offload(opt_state: Any, hbm_budget_bytes: int,
                 config: Optional[TppConfig] = None) -> OffloadPlan:
    """Greedy watermark plan: leaves stay in HBM, smallest first, until
    the demote watermark; the rest are host-resident."""
    config = config or TppConfig()
    sized = [(name, _leaf_bytes(x)) for name, x in nn.tree_leaves_with_path(opt_state)]
    usable = int(hbm_budget_bytes * (1.0 - config.wm_demote))
    placement: Dict[str, Tier] = {}
    used = 0
    for name, nbytes in sorted(sized, key=lambda kv: kv[1]):  # stable: ties in leaf order
        if used + nbytes <= usable:
            placement[name] = Tier.FAST
            used += nbytes
        else:
            placement[name] = Tier.SLOW
    return OffloadPlan(placement=placement, hbm_budget_bytes=hbm_budget_bytes, used_bytes=used)


def apply_placement(opt_state: Any, plan: OffloadPlan) -> Any:
    """The state with each ``SLOW`` leaf that lies on the card moved to
    pinned host memory; every other leaf is kept as it is (a CPU-only
    state comes back unchanged)."""
    def place(name: str, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and plan.placement.get(name) == Tier.SLOW:
            return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
        return x

    return nn.tree_map_with_path(place, opt_state)
