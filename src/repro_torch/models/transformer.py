"""Block specs and stacked block parameters (counterpart of
``repro/models/transformer.py``).

A model is ``n_layers`` blocks arranged as a repeating **pattern**;
parameters of each pattern position are **stacked over repeats**, so the
tree matches the JAX package's leaf for leaf (``init_stack``,
``repro/models/transformer.py:225-253``).  This slice builds attention +
FFN blocks; MoE, SSM mixers and shared (LoRA) blocks raise
``NotImplementedError`` until their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from repro_torch.models import nn
from repro_torch.models.attention import AttnConfig, init_gqa
from repro_torch.models.ffn import init_ffn
from repro_torch.models.nn import Params

_LATER = ("ROADMAP Queue 1 item 'other model families (window, rope2d, "
          "mrope, MoE)' / 'training path'")


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One block of the pattern."""

    kind: str  # attn | mamba2 | mlstm | slstm
    attn: Optional[AttnConfig] = None
    d_ff: int = 0
    ffn_kind: str = "swiglu"
    moe: Optional[Any] = None
    mamba: Optional[Any] = None
    mlstm: Optional[Any] = None
    slstm: Optional[Any] = None
    shared: bool = False  # zamba2 shared block (base params + LoRA)
    lora_rank: int = 64

    @property
    def has_ffn(self) -> bool:
        return self.d_ff > 0 or self.moe is not None


def _check_supported(spec: BlockSpec) -> None:
    if spec.kind != "attn":
        raise NotImplementedError(f"{spec.kind} blocks are not ported yet: {_LATER}")
    if spec.attn.is_mla:
        raise NotImplementedError(f"MLA attention is not ported yet: {_LATER}")
    if spec.moe is not None:
        raise NotImplementedError(f"MoE FFN blocks are not ported yet: {_LATER}")
    if spec.shared:
        raise NotImplementedError(f"shared (LoRA) blocks are not ported yet: {_LATER}")


def init_block(generator: torch.Generator, spec: BlockSpec, d_model: int,
               dtype=torch.float32, device="cuda") -> Params:
    _check_supported(spec)
    p: Params = {"norm1": nn.rmsnorm_init(d_model, dtype=dtype, device=device)}
    p["attn"] = init_gqa(generator, spec.attn, dtype, device)
    if spec.has_ffn:
        p["norm2"] = nn.rmsnorm_init(d_model, dtype=dtype, device=device)
        p["ffn"] = init_ffn(generator, d_model, spec.d_ff, spec.ffn_kind, dtype, device)
    return p


def _stack(trees: Sequence[Any]) -> Any:
    """Stack a list of identical trees leaf by leaf (leading dim)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(list(trees))


def init_stack(generator: torch.Generator, pattern: Sequence[BlockSpec],
               n_repeats: int, d_model: int, dtype=torch.float32,
               device="cuda") -> Params:
    """Stacked params: for each pattern position, leaves have a leading
    ``n_repeats`` dim; ``shared``/``lora`` hold None for plain blocks."""
    p: Params = {"blocks": [], "shared": [], "lora": []}
    for spec in pattern:
        reps = [init_block(generator, spec, d_model, dtype, device)
                for _ in range(n_repeats)]
        p["blocks"].append(_stack(reps))
        p["shared"].append(None)
        p["lora"].append(None)
    return p
