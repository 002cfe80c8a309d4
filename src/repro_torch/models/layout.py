"""Layouts the model states for DTensors (the dry-run's distribution).

The dry-run (``launch/dryrun.py``) runs the model on DTensors, where
DTensor's sharding propagation lays out each op: the port's counterpart
of GSPMD.  Some regions have no strategy DTensor can propagate through
(top-k, a cumsum in token order, indexed writes, views that split or
merge a sharded dim) or only one whose search grows with the mesh's
rank.  Those regions state their layout here, as JAX states ``_ep``'s
with ``with_sharding_constraint``: their inputs are laid out once, the
region runs on each device's local tensors, and its outputs are wrapped
back.  Every helper is a plain call on plain tensors, so the card's path
is unchanged.

* :func:`replicated`: every input replicated, the region computes all
  of it on every device (the MoE routing stage, dispatch and combine,
  which JAX computes on the global token set too).
* :func:`batch_local`: activations split over the batch mesh dims (and
  over ``model`` on a heads dim when every such dim divides it),
  weights replicated, each device computing its own rows: attention's
  core, the recurrent mixers, a decode step's cache update.
* :func:`batch_rows`: the residual stream's layout at every block
  boundary (batch split, replicated over ``model``: a row-parallel
  projection's partial sums are all-reduced there).
* :func:`vocab_embed`: the embedding lookup against a vocab-sharded
  table, each device looking up its own rows (vocab parallel).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models import nn

BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"


def _dtensors(*trees) -> list:
    return [x for tree in trees for x in nn.tree_leaves(tree) if isinstance(x, DTensor)]


def replicated(fn: Callable, *args, like: Optional[torch.Tensor] = None, **kwargs):
    """``fn(*args, **kwargs)``; on DTensors, every DTensor argument
    replicated first and ``fn`` run on the local values (each device
    computes all of it), its outputs replicated DTensors, or laid out as
    ``like`` (a partial sum there stands for its reduced value)."""
    dts = _dtensors(args, kwargs)
    if not dts:
        return fn(*args, **kwargs)
    mesh = dts[0].device_mesh
    rep = [Replicate()] * mesh.ndim

    def unwrap(a):
        return a.redistribute(mesh, rep).to_local() if isinstance(a, DTensor) else a

    out = fn(*map(unwrap, args), **{k: unwrap(v) for k, v in kwargs.items()})
    layout = rep if like is None else [Replicate() if p.is_partial() else p
                                       for p in like.placements]

    def wrap(t):
        return DTensor.from_local(t, mesh, rep, run_check=False).redistribute(mesh, layout)

    return nn.tree_map(wrap, out)


def batch_local(fn: Callable, *acts, params: Any = None,
                heads: Optional[Sequence[Optional[int]]] = None,
                out_heads: Optional[int] = None, writeback: Sequence[int] = ()):
    """``fn(*acts)`` (``fn(params, *acts)`` with ``params``) computed row
    by row on each device's batch shard.

    ``acts`` are tensors (or trees of them) whose dim 0 is the batch: on
    DTensors each is laid out with dim 0 split over the batch mesh dims
    the first one is split over, and replicated elsewhere; or, when
    ``heads`` names a dim of each act (None for one without; ``(dim,
    width)`` where heads of ``width`` elements lie packed along it) and
    the model mesh dim divides every such dim's head count, with that dim
    split over ``model`` too.  A plain tensor among DTensors counts as replicated.
    ``params`` (weights) are replicated; their gradients are partial sums
    over every split mesh dim.  ``fn`` runs on local tensors; each output
    takes the acts' layout, its heads dim ``out_heads``.  ``writeback``
    lists acts ``fn`` updates in place (a decode cache): their new local
    values are copied back into the caller's tensors."""
    dts = _dtensors(acts, params)
    if not dts:
        return fn(*acts) if params is None else fn(params, *acts)
    mesh = dts[0].device_mesh
    names = mesh.mesh_dim_names
    first = next(x for x in _dtensors(acts))
    split = [i for i, n in enumerate(names) if n in BATCH_AXES
             and isinstance(first.placements[i], Shard) and first.placements[i].dim == 0]
    model = names.index(MODEL_AXIS) if MODEL_AXIS in names else None
    # each heads entry: None, a dim, or (dim, width of one head along it)
    spans = [(h, 1) if isinstance(h, int) else h for h in (heads or [None] * len(acts))]
    heads = [None if h is None else h[0] for h in spans]
    tp = mesh.mesh.shape[model] if model is not None else 1
    head_split = model is not None and tp > 1 and any(h is not None for h in heads) and all(
        (x.shape[h[0]] // h[1]) % tp == 0 for a, h in zip(acts, spans) if h is not None
        for x in nn.tree_leaves(a) if isinstance(x, torch.Tensor))

    def layout(h):
        return [Shard(0) if i in split else
                Shard(h) if (i == model and head_split and h is not None) else Replicate()
                for i in range(mesh.ndim)]

    def to_local(x, h):
        if not isinstance(x, torch.Tensor):
            return x
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return x.redistribute(mesh, layout(h)).to_local()

    local = [nn.tree_map(lambda x, h=h: to_local(x, h), a) for a, h in zip(acts, heads)]
    if params is not None:
        rep = [Replicate()] * mesh.ndim
        grads = [Partial() if (i in split or (i == model and head_split)) else Replicate()
                 for i in range(mesh.ndim)]
        lp = nn.tree_map(lambda w: w.redistribute(mesh, rep).to_local(grad_placements=grads)
                         if isinstance(w, DTensor) else w, params)
        out = fn(lp, *local)
    else:
        out = fn(*local)
    for i in writeback:
        nn.tree_map(lambda orig, new, h=heads[i]: orig.copy_(DTensor.from_local(
            new, mesh, layout(h), run_check=False).redistribute(mesh, orig.placements))
            if isinstance(orig, DTensor) else None, acts[i], local[i])
    return nn.tree_map(lambda t: DTensor.from_local(t, mesh, layout(out_heads), run_check=False)
                       if isinstance(t, torch.Tensor) else t, out)


def model_rank(x: torch.Tensor) -> tuple:
    """``(this device's index, size)`` along the ``model`` mesh dim of a
    DTensor; ``(0, 1)`` for a plain tensor or a mesh without one."""
    if not isinstance(x, DTensor) or MODEL_AXIS not in x.device_mesh.mesh_dim_names:
        return 0, 1
    mesh = x.device_mesh
    dim = mesh.mesh_dim_names.index(MODEL_AXIS)
    return mesh.get_local_rank(dim), mesh.mesh.shape[dim]


def batch_rows(x: torch.Tensor) -> torch.Tensor:
    """The residual stream's layout: dim 0 split over the batch mesh dims
    it is split over, replicated elsewhere (a partial sum over ``model``,
    a row-parallel projection's output, is reduced here)."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    layout = [p if (n in BATCH_AXES and isinstance(p, Shard) and p.dim == 0) else Replicate()
              for n, p in zip(mesh.mesh_dim_names, x.placements)]
    return x.redistribute(mesh, layout)


def vocab_embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  On DTensors, against a table whose rows are split
    over ``model``, each device looks up the ids in its own rows (zeros
    elsewhere) and the rows add up over ``model`` (vocab parallel); the
    ids keep their batch layout."""
    if not isinstance(table, DTensor):
        return table[ids.long()]
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    model = names.index(MODEL_AXIS) if MODEL_AXIS in names else None
    sharded = model is not None and isinstance(table.placements[model], Shard)
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    split = [i for i, n in enumerate(names) if n in BATCH_AXES
             and isinstance(ids.placements[i], Shard) and ids.placements[i].dim == 0]
    id_layout = [Shard(0) if i in split else Replicate() for i in range(mesh.ndim)]
    ids_l = ids.redistribute(mesh, id_layout).to_local().long()
    t_layout = [Shard(0) if (i == model and sharded) else Replicate() for i in range(mesh.ndim)]
    t_grads = [Partial() if i in split else p for i, p in enumerate(t_layout)]
    t_l = table.redistribute(mesh, t_layout).to_local(grad_placements=t_grads)
    if sharded:
        rows = t_l.shape[0]
        lo = mesh.get_local_rank(model) * rows
        hit = (ids_l >= lo) & (ids_l < lo + rows)
        out = t_l[(ids_l - lo).clamp(0, rows - 1)] * hit[..., None].to(t_l.dtype)
    else:
        out = t_l[ids_l]
    out_layout = [Shard(0) if i in split else Partial() if (i == model and sharded)
                  else Replicate() for i in range(mesh.ndim)]
    return DTensor.from_local(out, mesh, out_layout, run_check=False)
