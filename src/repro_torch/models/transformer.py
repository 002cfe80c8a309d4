"""Block specs and stacked block parameters (counterpart of
``repro/models/transformer.py``).

A model is ``n_layers`` blocks arranged as a repeating **pattern**;
parameters of each pattern position are **stacked over repeats**, so the
tree matches the JAX package's leaf for leaf (``init_stack``,
``repro/models/transformer.py:225-253``).  A block's mixer is attention
(GQA, MHA or MLA, every rope variant, windowed or not) or a recurrent
mixer of ``models/ssm.py`` (Mamba2, mLSTM, sLSTM), with a dense FFN, an
MoE FFN or none.  A zamba2-style **shared** position keeps one
un-stacked base block in ``shared`` and per-repeat LoRA deltas, stacked,
in ``lora`` (``blocks`` holds None there).  :func:`stack_fwd` is the
training forward and :func:`stack_decode` one decode step over the
states of :func:`init_stack_state`: Python loops over repeats in place
of ``jax.lax.scan``, repeat ``r`` taking the ``[r]`` slice of every
stacked leaf and state.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.models import nn
from repro_torch.models.attention import (
    AttnConfig,
    attention_fwd,
    gqa_decode,
    init_attention,
    mla_decode,
)
from repro_torch.models.ffn import ffn_fwd, init_ffn
from repro_torch.models.layout import batch_local, batch_rows
from repro_torch.models.moe import MoeConfig, init_moe, moe_fwd
from repro_torch.models.nn import Params
from repro_torch.models.ssm import (
    Mamba2Config,
    MlstmConfig,
    SlstmConfig,
    init_mamba2,
    init_mlstm,
    init_slstm,
    mamba2_decode,
    mamba2_fwd,
    mamba2_init_state,
    mlstm_decode,
    mlstm_fwd,
    mlstm_init_state,
    slstm_decode,
    slstm_fwd,
    slstm_init_state,
)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One block of the pattern."""

    kind: str  # attn | mamba2 | mlstm | slstm
    attn: Optional[AttnConfig] = None
    d_ff: int = 0
    ffn_kind: str = "swiglu"
    moe: Optional[MoeConfig] = None
    mamba: Optional[Mamba2Config] = None
    mlstm: Optional[MlstmConfig] = None
    slstm: Optional[SlstmConfig] = None
    shared: bool = False  # zamba2 shared block (base params + LoRA)
    lora_rank: int = 64

    @property
    def has_ffn(self) -> bool:
        return self.d_ff > 0 or self.moe is not None


# ===================================================================== #
# single block
# ===================================================================== #
def init_block(generator: torch.Generator, spec: BlockSpec, d_model: int,
               dtype=torch.float32, device="cuda") -> Params:
    kw = dict(dtype=dtype, device=device)
    p: Params = {"norm1": nn.rmsnorm_init(d_model, **kw)}
    if spec.kind == "attn":
        p["attn"] = init_attention(generator, spec.attn, dtype, device)
    elif spec.kind == "mamba2":
        p["mixer"] = init_mamba2(generator, spec.mamba, dtype, device)
    elif spec.kind == "mlstm":
        p["mixer"] = init_mlstm(generator, spec.mlstm, dtype, device)
    elif spec.kind == "slstm":
        p["mixer"] = init_slstm(generator, spec.slstm, dtype, device)
    else:
        raise ValueError(spec.kind)
    if spec.has_ffn:
        p["norm2"] = nn.rmsnorm_init(d_model, **kw)
        if spec.moe is not None:
            p["moe"] = init_moe(generator, d_model, spec.moe, dtype, device)
        else:
            p["ffn"] = init_ffn(generator, d_model, spec.d_ff, spec.ffn_kind,
                                dtype, device)
    return p


def init_lora(generator: torch.Generator, spec: BlockSpec, d_model: int,
              dtype=torch.float32, device="cuda") -> Params:
    """LoRA deltas of a shared attention block (zamba2): ``qa``/``qb`` and
    ``oa``/``ob``, the ``b`` halves zero."""
    r = spec.lora_rank
    HD = spec.attn.n_heads * spec.attn.head_dim
    return {
        "qa": nn.normal_init(generator, (d_model, r), 0.02, dtype, device),
        "qb": torch.zeros((r, HD), dtype=dtype, device=device),
        "oa": nn.normal_init(generator, (HD, r), 0.02, dtype, device),
        "ob": torch.zeros((r, d_model), dtype=dtype, device=device),
    }


def _apply_lora(p_attn: Params, lora: Optional[Params], x_normed, y_attn_in=None):
    """JAX's hook (``repro/models/transformer.py:113-114``): the weights
    are not mutated; :func:`lora_delta` is added to the output instead."""
    return p_attn


def lora_delta(lora: Params, h: torch.Tensor) -> torch.Tensor:
    """The additive low-rank delta of a shared block on its normed input,
    ``ob(oa(qb(qa(h))))``, exactly as JAX writes it
    (``repro/models/transformer.py:130-133``)."""
    y = h
    for name in ("qa", "qb", "oa", "ob"):
        y = nn.dense({"w": lora[name]}, y)
    return y


def block_fwd(p: Params, spec: BlockSpec, x: torch.Tensor, positions: torch.Tensor,
              lora: Optional[Params] = None, impl: str = "chunked"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm block → ``(y, aux_loss)``
    (``repro/models/transformer.py:117-148``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = batch_rows(x)
    h = nn.rmsnorm(p["norm1"], x)
    if spec.kind == "attn":
        y = attention_fwd(p["attn"], spec.attn, h, positions, impl=impl)
        if lora is not None:
            y = y + lora_delta(lora, h)
    else:
        # a recurrent mixer: each sequence on its own, its weights replicated
        fwd = {"mamba2": (mamba2_fwd, spec.mamba), "mlstm": (mlstm_fwd, spec.mlstm),
               "slstm": (slstm_fwd, spec.slstm)}
        fn, cfg = fwd[spec.kind]
        y = batch_local(lambda pm, hh: fn(pm, cfg, hh), h, params=p["mixer"])
    x = x + batch_rows(y)
    if spec.has_ffn:
        h2 = nn.rmsnorm(p["norm2"], x)
        if spec.moe is not None:
            y2, aux = moe_fwd(p["moe"], spec.moe, h2)
        else:
            y2 = ffn_fwd(p["ffn"], h2, spec.ffn_kind)
        x = x + batch_rows(y2)
    return x, aux


# ===================================================================== #
# pattern stack
# ===================================================================== #
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


def _stacked(make, n_repeats: int) -> Params:
    """``make()`` called ``n_repeats`` times into stacked leaves, one
    repeat at a time: the peak is the stack plus one block, not twice the
    stack (8 layers of phi3.5-moe are 42.7 GB in float32)."""
    stacked = None
    for r in range(n_repeats):
        one = make()
        if stacked is None:
            stacked = _alloc_stacked(one, n_repeats)
        _fill(stacked, r, one)
        del one
    return stacked


def init_stack(generator: torch.Generator, pattern: Sequence[BlockSpec],
               n_repeats: int, d_model: int, dtype=torch.float32,
               device="cuda") -> Params:
    """Stacked params: for each pattern position, leaves have a leading
    ``n_repeats`` dim; ``shared``/``lora`` hold None for plain blocks.  A
    shared position holds None in ``blocks``, its base block once in
    ``shared`` and its stacked LoRA deltas in ``lora``."""
    p: Params = {"blocks": [], "shared": [], "lora": []}
    for spec in pattern:
        if spec.shared:
            p["blocks"].append(None)
            p["shared"].append(init_block(generator, spec, d_model, dtype, device))
            p["lora"].append(_stacked(
                lambda: init_lora(generator, spec, d_model, dtype, device), n_repeats))
        else:
            p["blocks"].append(_stacked(
                lambda: init_block(generator, spec, d_model, dtype, device), n_repeats))
            p["shared"].append(None)
            p["lora"].append(None)
    return p


def _unstack(tree: Optional[Params], n: int) -> list:
    """``n`` trees of views, the ``[r]`` slices of every stacked leaf
    (``n`` Nones for None)."""
    if tree is None:
        return [None] * n
    split = [t.unbind(0) for t in nn.tree_leaves(tree)]
    return [nn.tree_unflatten(tree, [s[r] for s in split]) for r in range(n)]


def _per_repeat(p: Params, n_repeats: int) -> Tuple[list, list]:
    """Per pattern position, each repeat's block params (a shared
    position's base for every repeat) and LoRA deltas (None or views)."""
    blocks = [_unstack(b, n_repeats) if b is not None else [base] * n_repeats
              for b, base in zip(p["blocks"], p["shared"])]
    loras = [_unstack(lo, n_repeats) for lo in p["lora"]]
    return blocks, loras


REMAT_POLICIES = (None, "dots")
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Selective checkpointing: keep matmul outputs without batch dims."""
    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint_contexts(remat_policy):
    """``checkpoint``'s ``context_fn`` for a remat policy."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}; "
                         f"choose one of {REMAT_POLICIES}")
    if remat_policy is None:
        return noop_context_fn
    return functools.partial(create_selective_checkpoint_contexts, _save_dots)


def stack_fwd(p: Params, pattern: Sequence[BlockSpec], n_repeats: int,
              x: torch.Tensor, positions: torch.Tensor, impl: str = "chunked",
              remat: bool = False, remat_policy=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The repeats in order, the pattern unrolled in each, repeat ``r``
    taking the ``[r]`` slice of every stacked leaf and a shared position
    its base with the ``[r]`` slice of its LoRA deltas
    (``repro/models/transformer.py:256-309``).

    ``remat=True`` recomputes each block in backward
    (``torch.utils.checkpoint``, non-reentrant): the same operations run
    again, so the gradients are those of ``remat=False`` bit for bit, and
    an MoE block launches its routing kernels twice a step.
    ``remat_policy`` picks what a rematerialised block keeps: None
    recomputes everything; ``"dots"`` (JAX's
    ``dots_with_no_batch_dims_saveable``) saves the outputs of matmuls
    without batch dims (``aten.mm``, ``aten.addmm``) and recomputes the
    rest, ``aten.bmm`` and the MoE kernels (which the dispatcher does not
    see) among it.
    """
    context_fn = _checkpoint_contexts(remat_policy)
    # each stacked leaf split once into its repeats: the backward of an
    # unbind is one stack, where indexing [r] repeat by repeat would add up
    # n_repeats gradients of the whole stacked leaf
    blocks, loras = _per_repeat(p, n_repeats)
    h = x
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(n_repeats):
        for pos, spec in enumerate(pattern):
            args = (blocks[pos][r], spec, h, positions, loras[pos][r], impl)
            if remat:
                h, a = checkpoint(block_fwd, *args, use_reentrant=False,
                                  context_fn=context_fn)
            else:
                h, a = block_fwd(*args)
            aux = aux + a
    return h, aux


# ===================================================================== #
# decode state and one decode step
# ===================================================================== #
def init_block_state(spec: BlockSpec, batch: int, max_len: int, dtype=torch.float32,
                     device="cuda") -> Params:
    """A block's initial decode state (``repro/models/transformer.py:154-175``):
    MLA's latent ``ckv (B, max_len, r)`` and ``krope (B, max_len, dr)``;
    GQA's ``k``/``v (B, W, Hkv, D)`` with ``W = max_len``, or
    ``min(max_len, window)`` for a windowed layer, whose cache is then a
    rolling buffer; a recurrent mixer's state of ``models/ssm.py``."""
    kw = dict(dtype=dtype, device=device)
    if spec.kind == "attn":
        a = spec.attn
        if a.is_mla:
            return {"ckv": torch.zeros((batch, max_len, a.kv_lora_rank), **kw),
                    "krope": torch.zeros((batch, max_len, a.qk_rope_dim), **kw)}
        w = max_len if a.window is None else min(max_len, a.window)
        return {"k": torch.zeros((batch, w, a.n_kv_heads, a.head_dim), **kw),
                "v": torch.zeros((batch, w, a.n_kv_heads, a.head_dim), **kw)}
    if spec.kind == "mamba2":
        return mamba2_init_state(spec.mamba, batch, dtype, device)
    if spec.kind == "mlstm":
        return mlstm_init_state(spec.mlstm, batch, device)
    return slstm_init_state(spec.slstm, batch, device)


def block_decode(p: Params, spec: BlockSpec, x: torch.Tensor, state: Params,
                 cur_len, positions: torch.Tensor, lora: Optional[Params] = None
                 ) -> Tuple[torch.Tensor, Params]:
    """One block's decode step → ``(y, state)``
    (``repro/models/transformer.py:178-219``).  ``state`` is updated in
    place and returned: an attention cache gets the new token's slot (a
    windowed layer whose cache holds exactly ``window`` slots decodes over
    it as a rolling buffer), a recurrent mixer's new state is copied into
    its tensors."""
    x = batch_rows(x)
    h = nn.rmsnorm(p["norm1"], x)
    if spec.kind == "attn":
        a = spec.attn
        if a.is_mla:
            y, _, _ = mla_decode(p["attn"], a, h, state["ckv"], state["krope"],
                                 cur_len, positions)
        else:
            rolling = a.window is not None and state["k"].shape[-3] == a.window
            y, _, _ = gqa_decode(p["attn"], a, h, state["k"], state["v"], cur_len,
                                 positions, rolling=rolling)
        if lora is not None:
            y = y + lora_delta(lora, h)
    else:
        step = {"mamba2": (mamba2_decode, spec.mamba), "mlstm": (mlstm_decode, spec.mlstm),
                "slstm": (slstm_decode, spec.slstm)}
        fn, cfg = step[spec.kind]
        y, new = batch_local(lambda pm, hh, st: fn(pm, cfg, hh, st), h, state,
                             params=p["mixer"])
        for k, t in state.items():
            t.copy_(new[k])
    x = x + batch_rows(y)
    if spec.has_ffn:
        h2 = nn.rmsnorm(p["norm2"], x)
        if spec.moe is not None:
            y2, _ = moe_fwd(p["moe"], spec.moe, h2)
        else:
            y2 = ffn_fwd(p["ffn"], h2, spec.ffn_kind)
        x = x + batch_rows(y2)
    return x, state


def init_stack_state(pattern: Sequence[BlockSpec], n_repeats: int, batch: int,
                     max_len: int, dtype=torch.float32, device="cuda") -> list:
    """Per pattern position, its block's initial state broadcast over a
    leading ``n_repeats`` dim (``repro/models/transformer.py:312-328``):
    mLSTM's ``m`` starts at -1e9 and sLSTM's ``n`` at one in every repeat."""
    def stack(a: torch.Tensor) -> torch.Tensor:
        return a.new_empty((n_repeats,) + tuple(a.shape)).copy_(a)

    return [nn.tree_map(stack, init_block_state(spec, batch, max_len, dtype, device))
            for spec in pattern]


def stack_decode(p: Params, pattern: Sequence[BlockSpec], n_repeats: int,
                 x: torch.Tensor, states: list, cur_len, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, list]:
    """One decode step through the stack (``repro/models/transformer.py:331-358``):
    the repeats in order, the pattern unrolled in each, repeat ``r``
    taking the ``[r]`` slice of every stacked leaf and state (a shared
    position its base and the ``[r]`` slice of its LoRA deltas).  The
    slices are views, so each block's state is updated in place in
    ``states``, which is returned."""
    blocks, loras = _per_repeat(p, n_repeats)
    state_views = [_unstack(st, n_repeats) for st in states]
    h = x
    for r in range(n_repeats):
        for pos, spec in enumerate(pattern):
            h, _ = block_decode(blocks[pos][r], spec, h, state_views[pos][r],
                                cur_len, positions, lora=loras[pos][r])
    return h, states
