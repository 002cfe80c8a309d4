"""Top-level model config and parameters (counterpart of ``repro/models/model.py``).

:func:`init_params` builds the port's own seeded weights;
:func:`params_from_jax` converts the JAX package's parameters, handed
over as a tree of numpy arrays, into the same tree of tensors.  Both
trees match ``repro.models.model.init_params`` leaf for leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import nn
from repro_torch.models.nn import Params
from repro_torch.models.transformer import BlockSpec, init_stack


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | hybrid | moe | audio | vlm
    d_model: int
    vocab: int
    # sequential stacks: ((pattern, n_repeats), ...) — total layers is the
    # sum of len(pattern) * n_repeats.
    stacks: Tuple[Tuple[Tuple[BlockSpec, ...], int], ...]
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    n_codebooks: int = 1
    vision_stub: bool = False
    mrope: bool = False
    subquadratic: bool = False
    z_loss: float = 1e-4
    aux_loss_weight: float = 0.01

    @property
    def n_layers(self) -> int:
        return sum(len(pat) * reps for pat, reps in self.stacks)

    def all_specs(self) -> List[BlockSpec]:
        out: List[BlockSpec] = []
        for pat, reps in self.stacks:
            out.extend(list(pat) * reps)
        return out

    def max_window(self) -> Optional[int]:
        """Largest attention window (None if any attn layer is full-range)."""
        ws = []
        for s in self.all_specs():
            if s.kind == "attn":
                if s.attn.window is None:
                    return None
                ws.append(s.attn.window)
        return max(ws) if ws else 0


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of dicts, lists and None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=torch.float32) -> Params:
    """Seeded random weights; the tree of ``repro.models.model.init_params``.

    Draws come from ``generator`` on its own device (pass a CUDA
    generator to build full-width weights on the card).
    """
    if cfg.n_codebooks != 1 or cfg.vision_stub:
        raise NotImplementedError(
            "codebook and vision-stub models are not ported yet: ROADMAP "
            "Queue 1 item 'other model families'"
        )
    kw = dict(dtype=dtype, device=device)
    p: Params = {
        "embed": nn.embedding_init(generator, cfg.vocab, cfg.d_model, **kw),
        "stacks": [init_stack(generator, pat, reps, cfg.d_model, **kw)
                   for pat, reps in cfg.stacks],
        "final_norm": nn.rmsnorm_init(cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = nn.dense_init(generator, cfg.d_model, cfg.vocab, std=0.02, **kw)
    return p


def params_from_jax(tree: Any, device="cuda", dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX package's parameters, as a tree of numpy arrays, → tensors.

    The tree's structure (dicts, lists, None) is kept; each leaf is copied
    to ``device`` (and cast to ``dtype`` when given).  Imports nothing of
    JAX: the caller converts with ``np.asarray`` first.
    """
    def leaf(x):
        t = torch.from_numpy(np.array(x, copy=True))
        return t.to(device=device, dtype=dtype or t.dtype)

    return tree_map(leaf, tree)
