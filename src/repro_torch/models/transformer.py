"""Block specs and stacked block parameters (counterpart of
``repro/models/transformer.py``).

A model is ``n_layers`` blocks arranged as a repeating **pattern**;
parameters of each pattern position are **stacked over repeats**, so the
tree matches the JAX package's leaf for leaf (``init_stack``,
``repro/models/transformer.py:225-253``).  The port builds and runs
attention blocks (GQA, MHA or MLA, every rope variant, windowed or not)
with a dense FFN or an MoE FFN.  :func:`stack_fwd` is the training
forward and :func:`stack_decode` one decode step over the caches of
:func:`init_stack_state`: Python loops over repeats in place of
``jax.lax.scan``, repeat ``r`` taking the ``[r]`` slice of every stacked
leaf and state.  SSM mixers (mamba2, mLSTM, sLSTM) and shared (LoRA)
blocks raise ``NotImplementedError`` until their slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import nn
from repro_torch.models.attention import (
    AttnConfig,
    attention_fwd,
    gqa_decode,
    init_attention,
    mla_decode,
)
from repro_torch.models.ffn import ffn_fwd, init_ffn
from repro_torch.models.moe import MoeConfig, init_moe, moe_fwd
from repro_torch.models.nn import Params

_LATER = ("ROADMAP Queue 1 item 7b, 'MLA and the SSM mixers, part 2: the SSM "
          "mixers' (zamba2's mamba2 and shared blocks, xlstm's mLSTM and sLSTM)")


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
    if spec.shared:
        raise NotImplementedError(f"shared (LoRA) blocks are not ported yet: {_LATER}")


def init_block(generator: torch.Generator, spec: BlockSpec, d_model: int,
               dtype=torch.float32, device="cuda") -> Params:
    _check_supported(spec)
    p: Params = {"norm1": nn.rmsnorm_init(d_model, dtype=dtype, device=device)}
    p["attn"] = init_attention(generator, spec.attn, dtype, device)
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


# ===================================================================== #
# decode state and one decode step
# ===================================================================== #
def init_block_state(spec: BlockSpec, batch: int, max_len: int, dtype=torch.float32,
                     device="cuda") -> Params:
    """A block's zeroed decode caches (``repro/models/transformer.py:154-175``):
    MLA's latent ``ckv (B, max_len, r)`` and ``krope (B, max_len, dr)``;
    GQA's ``k``/``v (B, W, Hkv, D)`` with ``W = max_len``, or
    ``min(max_len, window)`` for a windowed layer, whose cache is then a
    rolling buffer."""
    _check_supported(spec)
    a = spec.attn
    kw = dict(dtype=dtype, device=device)
    if a.is_mla:
        return {"ckv": torch.zeros((batch, max_len, a.kv_lora_rank), **kw),
                "krope": torch.zeros((batch, max_len, a.qk_rope_dim), **kw)}
    w = max_len if a.window is None else min(max_len, a.window)
    return {"k": torch.zeros((batch, w, a.n_kv_heads, a.head_dim), **kw),
            "v": torch.zeros((batch, w, a.n_kv_heads, a.head_dim), **kw)}


def block_decode(p: Params, spec: BlockSpec, x: torch.Tensor, state: Params,
                 cur_len, positions: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One block's decode step → ``(y, state)``
    (``repro/models/transformer.py:178-222``); the caches in ``state`` are
    written in place and returned.  A windowed layer whose cache holds
    exactly ``window`` slots decodes over it as a rolling buffer."""
    _check_supported(spec)
    h = nn.rmsnorm(p["norm1"], x)
    a = spec.attn
    if a.is_mla:
        y, ckv, krope = mla_decode(p["attn"], a, h, state["ckv"], state["krope"],
                                   cur_len, positions)
        state = {"ckv": ckv, "krope": krope}
    else:
        rolling = a.window is not None and state["k"].shape[-3] == a.window
        y, kc, vc = gqa_decode(p["attn"], a, h, state["k"], state["v"], cur_len,
                               positions, rolling=rolling)
        state = {"k": kc, "v": vc}
    x = x + y
    if spec.has_ffn:
        h2 = nn.rmsnorm(p["norm2"], x)
        if spec.moe is not None:
            y2, _ = moe_fwd(p["moe"], spec.moe, h2)
        else:
            y2 = ffn_fwd(p["ffn"], h2, spec.ffn_kind)
        x = x + y2
    return x, state


def init_stack_state(pattern: Sequence[BlockSpec], n_repeats: int, batch: int,
                     max_len: int, dtype=torch.float32, device="cuda") -> list:
    """Per pattern position, its block's state with a leading ``n_repeats``
    dim (``repro/models/transformer.py:312-328``)."""
    return [nn.tree_map(lambda a: a.new_zeros((n_repeats,) + tuple(a.shape)),
                        init_block_state(spec, batch, max_len, dtype, device))
            for spec in pattern]


def stack_decode(p: Params, pattern: Sequence[BlockSpec], n_repeats: int,
                 x: torch.Tensor, states: list, cur_len, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, list]:
    """One decode step through the stack (``repro/models/transformer.py:331-358``):
    the repeats in order, the pattern unrolled in each, repeat ``r``
    taking the ``[r]`` slice of every stacked leaf and state.  The slices
    are views, so each block's caches are updated in place in ``states``,
    which is returned."""
    per_repeat = [_unstack(b, n_repeats) for b in p["blocks"]]
    state_views = [_unstack(st, n_repeats) for st in states]
    h = x
    for r in range(n_repeats):
        for pos, spec in enumerate(pattern):
            h, _ = block_decode(per_repeat[pos][r], spec, h, state_views[pos][r],
                                cur_len, positions)
    return h, states
