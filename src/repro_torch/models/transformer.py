"""Block specs and stacked block parameters (counterpart of
``repro/models/transformer.py``).

A model is ``n_layers`` blocks arranged as a repeating **pattern**;
parameters of each pattern position are **stacked over repeats**, so the
tree matches the JAX package's leaf for leaf (``init_stack``,
``repro/models/transformer.py:225-253``).  The port builds and runs
attention blocks (GQA or MHA, every rope variant, windowed or not) with
a dense FFN or an MoE FFN: every block of the seven architectures the
serving engine pages.  :func:`stack_fwd` is the training forward: a
Python loop over repeats in place of ``jax.lax.scan``, each block
optionally recomputed in backward (``remat``).  SSM mixers (mamba2,
mLSTM, sLSTM), MLA and shared (LoRA) blocks raise
``NotImplementedError`` until their slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import nn
from repro_torch.models.attention import AttnConfig, attention_fwd, init_gqa
from repro_torch.models.ffn import ffn_fwd, init_ffn
from repro_torch.models.moe import MoeConfig, init_moe, moe_fwd
from repro_torch.models.nn import Params

_LATER = ("ROADMAP Queue 1 item 7, 'MLA and the SSM mixers' (deepseek-v2-lite's "
          "MLA, zamba2's mamba2 and shared blocks, xlstm's mLSTM and sLSTM)")


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


def block_fwd(p: Params, spec: BlockSpec, x: torch.Tensor, positions: torch.Tensor,
              impl: str = "chunked") -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm block → ``(y, aux_loss)``
    (``repro/models/transformer.py:117-151``)."""
    _check_supported(spec)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = nn.rmsnorm(p["norm1"], x)
    x = x + attention_fwd(p["attn"], spec.attn, h, positions, impl=impl)
    if spec.has_ffn:
        h2 = nn.rmsnorm(p["norm2"], x)
        if spec.moe is not None:
            y2, aux = moe_fwd(p["moe"], spec.moe, h2)
        else:
            y2 = ffn_fwd(p["ffn"], h2, spec.ffn_kind)
        x = x + y2
    return x, aux


def _unstack(tree: Params, n: int) -> list:
    """``n`` trees of views, the ``[r]`` slices of every stacked leaf."""
    split = [t.unbind(0) for t in nn.tree_leaves(tree)]
    return [nn.tree_unflatten(tree, [s[r] for s in split]) for r in range(n)]


def stack_fwd(p: Params, pattern: Sequence[BlockSpec], n_repeats: int,
              x: torch.Tensor, positions: torch.Tensor, impl: str = "chunked",
              remat: bool = False, remat_policy=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The repeats in order, the pattern unrolled in each, repeat ``r``
    taking the ``[r]`` slice of every stacked leaf
    (``repro/models/transformer.py:256-309``).

    ``remat=True`` recomputes each block in backward
    (``torch.utils.checkpoint``, non-reentrant): the same operations run
    again, so the gradients are those of ``remat=False`` bit for bit, and
    an MoE block launches its routing kernels twice a step.
    """
    if remat_policy is not None:
        raise NotImplementedError(
            "remat_policy is a JAX checkpoint policy; the port recomputes whole "
            "blocks only: ROADMAP Queue 1 item 7, 'mesh, shardings and dry-run'")
    for spec in pattern:
        _check_supported(spec)
    # each stacked leaf split once into its repeats: the backward of an
    # unbind is one stack, where indexing [r] repeat by repeat would add up
    # n_repeats gradients of the whole stacked leaf
    per_repeat = [_unstack(b, n_repeats) for b in p["blocks"]]
    h = x
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(n_repeats):
        for pos, spec in enumerate(pattern):
            params = per_repeat[pos][r]
            if remat:
                h, a = checkpoint(block_fwd, params, spec, h, positions, impl,
                                  use_reentrant=False)
            else:
                h, a = block_fwd(params, spec, h, positions, impl=impl)
            aux = aux + a
    return h, aux
