"""Block specs and stacked block parameters (counterpart of
``repro/models/transformer.py``).

A model is ``n_layers`` blocks arranged as a repeating **pattern**;
parameters of each pattern position are **stacked over repeats**, so the
tree matches the JAX package's leaf for leaf (``init_stack``,
``repro/models/transformer.py:225-253``).  The port builds attention
blocks with a dense FFN or an MoE FFN; SSM mixers, MLA and shared
(LoRA) blocks raise ``NotImplementedError`` until their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from repro_torch.models import nn
from repro_torch.models.attention import AttnConfig, init_gqa
from repro_torch.models.ffn import init_ffn
from repro_torch.models.moe import MoeConfig, init_moe
from repro_torch.models.nn import Params

_LATER = ("ROADMAP Queue 1 item 'other model families' / 'training path'")


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One block of the pattern."""

    kind: str  # attn | mamba2 | mlstm | slstm
    attn: Optional[AttnConfig] = None
    d_ff: int = 0
    ffn_kind: str = "swiglu"
    moe: Optional[MoeConfig] = None
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
    if spec.shared:
        raise NotImplementedError(f"shared (LoRA) blocks are not ported yet: {_LATER}")


def init_block(generator: torch.Generator, spec: BlockSpec, d_model: int,
               dtype=torch.float32, device="cuda") -> Params:
    _check_supported(spec)
    p: Params = {"norm1": nn.rmsnorm_init(d_model, dtype=dtype, device=device)}
    p["attn"] = init_gqa(generator, spec.attn, dtype, device)
    if spec.has_ffn:
        p["norm2"] = nn.rmsnorm_init(d_model, dtype=dtype, device=device)
        if spec.moe is not None:
            p["moe"] = init_moe(generator, d_model, spec.moe, dtype, device)
        else:
            p["ffn"] = init_ffn(generator, d_model, spec.d_ff, spec.ffn_kind,
                                dtype, device)
    return p


def _alloc_stacked(first: Any, n: int) -> Any:
    """An uninitialised tree shaped like ``first`` with a leading ``n`` dim."""
    if isinstance(first, dict):
        return {k: _alloc_stacked(v, n) for k, v in first.items()}
    return first.new_empty((n,) + tuple(first.shape))


def _fill(stacked: Any, r: int, tree: Any) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _fill(stacked[k], r, v)
    else:
        stacked[r].copy_(tree)


def init_stack(generator: torch.Generator, pattern: Sequence[BlockSpec],
               n_repeats: int, d_model: int, dtype=torch.float32,
               device="cuda") -> Params:
    """Stacked params: for each pattern position, leaves have a leading
    ``n_repeats`` dim; ``shared``/``lora`` hold None for plain blocks."""
    p: Params = {"blocks": [], "shared": [], "lora": []}
    for spec in pattern:
        # one repeat at a time into the stacked leaves: the peak is the
        # stack plus one block, not twice the stack (8 layers of
        # phi3.5-moe are 42.7 GB in float32)
        stacked = None
        for r in range(n_repeats):
            block = init_block(generator, spec, d_model, dtype, device)
            if stacked is None:
                stacked = _alloc_stacked(block, n_repeats)
            _fill(stacked, r, block)
            del block
        p["blocks"].append(stacked)
        p["shared"].append(None)
        p["lora"].append(None)
    return p
