"""Sharding rules: params / optimizer / batch / decode state → specs and
DTensor placements (counterpart of ``repro/launch/shardings.py``).

Strategy: tensor parallelism on the ``model`` axis, batch over (``pod``,
``data``).  The rules are the JAX package's, path and shape based and
**divisibility-guarded**: a dim is sharded only when the axis size
divides it, else the leaf is replicated (chatglm's 2 KV heads and
gemma3's 8 Q heads stay replicated on a 16-wide model axis).  Attention
projections shard only when the heads divide the axis (a packed
``(d, H·D)`` dim split inside a head misaligns the ``(B, S, H, D)``
reshape).  MoE expert banks shard their expert dim (expert parallelism
on the model axis).  Recurrent mixers keep their packed projections
replicated.

A **spec** is the content of JAX's ``PartitionSpec`` as a tuple: per
tensor dim ``None``, an axis name or a tuple of axis names (``()`` is
fully replicated).  :func:`placements` turns one into DTensor
placements for a mesh: ``Shard(dim)`` on each mesh dim whose axis the
spec names, ``Replicate()`` elsewhere, so a batch dim over ``("pod",
"data")`` is ``Shard(0)`` on both of those mesh dims.  The ``shard_*``
functions return trees of :class:`Sharding` (a spec with its placements
and per-device shape) over the port's own trees: the params of
``init_params``, the ``AdamWState`` of ``optim.init``, the batch dict and
the per-stack lists of ``init_decode_state``.  Those trees are stacked
over repeats as JAX's are, so dims counted from the end mean the same.

A ``mesh`` argument is a ``DeviceMesh`` or a ``{axis: size}`` dict in
mesh order (the rules read only the sizes).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import batch_axes
from repro_torch.models import nn

# path keywords → preferred dim to shard on the model axis
# (dim index from the END, so stacked leading repeat dims don't matter)
_COL = {"wi_gate", "wi_up", "wi", "lm_head", "qa", "oa"}
_ROW = {"wkv_b", "qb", "ob"}
_ATTN_Q = {"wq"}
_ATTN_KV = {"wk", "wv"}
_ATTN_O = {"wo"}
_EXPERT = {"wi_gate", "wi_up", "wo"}  # under a "moe" parent
_REPLICATE = {"norm", "norm1", "norm2", "kv_norm", "final_norm", "conv_w",
              "conv_b", "dt_bias", "A_log", "D", "b_i", "b_f", "b_z", "b_o",
              "router", "scale", "bias", "in_proj", "out_proj", "up_proj",
              "down_proj", "w_i", "w_f", "w_z", "w_o", "r_i", "r_f", "r_z",
              "r_o", "out", "patch_proj"}

Spec = Tuple[Any, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _spec_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    out = []
    for axis in axis_sizes(mesh):
        dims = [d for d, e in enumerate(spec) if axis in _spec_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard_shape(spec: Spec, shape: Sequence[int], mesh) -> tuple:
    """The per-device shape of a ``shape`` tensor under ``spec``."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, e in enumerate(spec):
        for axis in _spec_axes(e):
            if out[d] % sizes[axis]:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split over "
                                 f"{axis}={sizes[axis]}")
            out[d] //= sizes[axis]
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh: JAX's ``NamedSharding`` (a leaf of the trees)."""

    axes: Tuple[Tuple[str, int], ...]  # (name, size) per mesh dim
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, dict(self.axes))

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        return shard_shape(self.spec, shape, dict(self.axes))


def _sharding(mesh, spec: Spec) -> Sharding:
    return Sharding(tuple(axis_sizes(mesh).items()), tuple(spec))


def path_names(path: str) -> list:
    """The keys of an ``nn.tree_leaves_with_path`` path (``['w']`` → ``w``,
    ``[0]`` → ``0``; a NamedTuple field keeps its dot, as JAX's key does)."""
    out = []
    for part in path.split("/") if path else []:
        if part.startswith("['") and part.endswith("']"):
            out.append(part[2:-2])
        elif part.startswith("["):
            out.append(part[1:-1])
        else:
            out.append(part)
    return out


def param_spec(names: Sequence[str], shape: Sequence[int], model_axis: str,
               axis_size: int, q_align: bool = True, kv_align: bool = True) -> Spec:
    """The spec of one parameter leaf at path ``names`` (keys from the
    root) with ``shape`` (``repro/launch/shardings.py:57-115``)."""
    names = list(names)
    nameset = set(names)
    shape = tuple(shape)
    nd = len(shape)

    def ok(dim_from_end: int) -> bool:
        return nd > dim_from_end and shape[nd - 1 - dim_from_end] % axis_size == 0

    def spec(dim_from_end: int) -> Spec:
        parts = [None] * nd
        parts[nd - 1 - dim_from_end] = model_axis
        return tuple(parts)

    leafname = names[-2] if names[-1] in ("w", "b") else names[-1]
    in_mixer = "mixer" in nameset  # mLSTM wq/wk/wv etc. → replicate

    if leafname in _REPLICATE:
        return ()
    # MoE expert banks: (..., E, d, F) — shard experts (EP)
    if "moe" in nameset and names[-1] in _EXPERT and nd >= 3:
        if shape[nd - 3] % axis_size == 0:
            parts = [None] * nd
            parts[nd - 3] = model_axis
            return tuple(parts)
        return spec(1) if ok(1) else ()
    # embeddings: shard vocab (dim -2)
    if "embed" in nameset and names[-1] == "table":
        return spec(1) if ok(1) else ()
    if names[-1] == "b":
        if leafname in (_COL | _ATTN_Q | _ATTN_KV) and shape[-1] % axis_size == 0:
            if leafname in _ATTN_Q and not q_align:
                return ()
            if leafname in _ATTN_KV and not kv_align:
                return ()
            if in_mixer:
                return ()
            return spec(0)
        return ()
    in_attn = "attn" in nameset and not in_mixer
    if leafname in _ATTN_Q and in_attn:
        return spec(0) if (q_align and ok(0)) else ()
    if leafname in _ATTN_KV and in_attn:
        return spec(0) if (kv_align and ok(0)) else ()
    if leafname in _ATTN_O and in_attn:
        # row-shard over the H·D contraction dim — only if q heads align
        return spec(1) if (q_align and ok(1)) else ()
    if leafname in _COL:
        return spec(0) if ok(0) else ()
    if leafname in _ROW or (leafname in _ATTN_O and not in_attn):
        # ffn down-projection: row-shard the d_ff contraction dim
        return spec(1) if ok(1) else (spec(0) if ok(0) else ())
    return ()


def attn_alignment(cfg, axis_size: int) -> Tuple[bool, bool]:
    """(q_align, kv_align): do the arch's attention head counts divide
    the model axis?  (All attn layers in our archs share head counts.)"""
    for s in cfg.all_specs():
        if s.kind == "attn":
            a = s.attn
            if a.is_mla:
                return (a.n_heads % axis_size == 0,) * 2
            return (a.n_heads % axis_size == 0, a.n_kv_heads % axis_size == 0)
    return (False, False)


def shard_params(params: Any, mesh, model_axis: str = "model",
                 cfg: Optional[Any] = None) -> Any:
    axis_size = axis_sizes(mesh)[model_axis]
    q_align, kv_align = attn_alignment(cfg, axis_size) if cfg is not None else (True, True)
    return nn.tree_map_with_path(
        lambda path, leaf: _sharding(mesh, param_spec(
            path_names(path), leaf.shape, model_axis, axis_size,
            q_align=q_align, kv_align=kv_align)),
        params)


def shard_opt_state(opt_state: Any, params_sharding: Any, mesh) -> Any:
    """Moments/master mirror the parameter shardings; the step replicates."""
    rep = _sharding(mesh, ())
    mirror = lambda tree: nn.tree_map(lambda s, _x: s, params_sharding, tree)
    master = mirror(opt_state.master) if opt_state.master is not None else None
    return type(opt_state)(step=rep, m=mirror(opt_state.m), v=mirror(opt_state.v),
                           master=master)


def batch_spec(mesh, shape: Sequence[int], leading_stack: bool = False) -> Spec:
    """Batch-dim sharding over (pod, data), guarded by divisibility
    (long_500k's batch=1 falls back to replication).  ``leading_stack``
    skips a leading non-batch dim (e.g. M-RoPE positions (3, B, S))."""
    sizes = axis_sizes(mesh)
    ax = batch_axes(mesh)
    nb = 1
    for a in ax:
        nb *= sizes[a]
    ndim = len(shape)
    parts = [None] * ndim
    bdim = 1 if leading_stack else 0
    if ndim > bdim and shape[bdim] % nb == 0:
        parts[bdim] = ax if len(ax) > 1 else ax[0]
    return tuple(parts)


def shard_batch(mesh, batch: Any) -> Any:
    def f(path, leaf):
        lead = path_names(path)[-1] == "positions" and leaf.dim() == 3
        return _sharding(mesh, batch_spec(mesh, leaf.shape, leading_stack=lead))

    return nn.tree_map_with_path(f, batch)


def zero1_shardings(params_sharding: Any, shapes: Any, mesh, axis: str = "data") -> Any:
    """ZeRO-1: additionally shard optimizer-state leaves over the data
    axis (first divisible dim not already sharded).  ``shapes`` is the
    matching tree of tensors (``meta`` ones will do); leaves under 65536
    elements stay as they are."""
    n = axis_sizes(mesh)[axis]

    def f(s: Sharding, shp) -> Sharding:
        shape = tuple(shp.shape)
        size = 1
        for d_ in shape:
            size *= int(d_)
        if size < 65536:
            return s
        spec = list(s.spec) + [None] * (len(shape) - len(s.spec))
        for d in range(len(shape)):
            if spec[d] is None and shape[d] % n == 0:
                spec[d] = axis
                return Sharding(s.axes, tuple(spec))
        return s

    return nn.tree_map(f, params_sharding, shapes)


def shard_decode_state(states: Any, mesh, model_axis: str = "model") -> Any:
    """KV caches: batch on (pod, data); the kv-head dim on model when
    divisible, else the **sequence dim** of the cache (flash-decoding
    style KV sequence sharding: how the few-KV-head archs fit 32k-500k
    caches).

    Cache layouts (stacked over repeats): k/v (R, B, T, Hkv, D); MLA
    ckv/krope (R, B, T, r); SSM states (R, B, H, ...).  Batch = dim 1.
    """
    sizes = axis_sizes(mesh)
    axis_size = sizes[model_axis]
    ax = batch_axes(mesh)
    nb = 1
    for a in ax:
        nb *= sizes[a]
    bspec = ax if len(ax) > 1 else ax[0]

    def f(path, leaf):
        name = path_names(path)[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        parts = [None] * nd
        if nd >= 2 and shape[1] % nb == 0:
            parts[1] = bspec  # batch dim (after the stacked-repeat dim)
        if name in ("k", "v") and nd == 5:
            if shape[3] % axis_size == 0:
                parts[3] = model_axis  # kv heads
            elif shape[2] % axis_size == 0:
                parts[2] = model_axis  # cache sequence dim
        elif name in ("ckv", "krope") and nd == 4:
            if shape[2] % axis_size == 0:
                parts[2] = model_axis  # MLA latent cache sequence dim
        elif name == "kv" and nd == 5:
            if shape[2] % axis_size == 0:
                parts[2] = model_axis  # mLSTM heads (R,B,H,Dk,Dv)
            elif shape[4] % axis_size == 0:
                parts[4] = model_axis  # mLSTM value dim
        elif name == "ssm" and nd == 5 and shape[2] % axis_size == 0:
            parts[2] = model_axis  # mamba2 heads (R,B,H,P,N)
        elif name == "conv" and nd == 4 and shape[3] % axis_size == 0:
            parts[3] = model_axis  # mamba2 conv channels
        return _sharding(mesh, tuple(parts))

    return nn.tree_map_with_path(f, states)
