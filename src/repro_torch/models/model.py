"""Top-level model: config, parameters, forward and training loss
(counterpart of ``repro/models/model.py``).

:func:`init_params` builds the port's own seeded weights;
:func:`params_from_jax` converts the JAX package's parameters, handed
over as a tree of numpy arrays, into the same tree of tensors.  Both
trees match ``repro.models.model.init_params`` leaf for leaf.
:func:`forward` (embeddings → pattern stacks → head) and :func:`loss_fn`
(cross-entropy + z-loss + MoE aux) are the training path; gradients come
from ``torch.autograd``.  ``decode_step`` is a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import nn
from repro_torch.models.nn import Params
from repro_torch.models.transformer import BlockSpec, init_stack, stack_fwd


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


tree_map = nn.tree_map  # one tree walk for the package


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=torch.float32) -> Params:
    """Seeded random weights; the tree of ``repro.models.model.init_params``.

    Draws come from ``generator`` on its own device (pass a CUDA
    generator to build full-width weights on the card).
    """
    kw = dict(dtype=dtype, device=device)
    K = cfg.n_codebooks  # musicgen: one table row per (codebook, id)
    p: Params = {
        "embed": nn.embedding_init(generator, cfg.vocab * K, cfg.d_model, **kw),
        "stacks": [init_stack(generator, pat, reps, cfg.d_model, **kw)
                   for pat, reps in cfg.stacks],
        "final_norm": nn.rmsnorm_init(cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = nn.dense_init(generator, cfg.d_model, cfg.vocab * K,
                                     std=0.02, **kw)
    if cfg.vision_stub:
        # qwen2-vl: the stub frontend's projection of precomputed patch
        # embeddings (the serving engine feeds text only and never reads it)
        p["patch_proj"] = nn.dense_init(generator, cfg.d_model, cfg.d_model, **kw)
    return p


def param_bytes(cfg: ModelConfig, dtype=torch.float32) -> int:
    """Bytes of ``init_params(cfg)`` in ``dtype``, from a build on the
    ``meta`` device (shapes only: no memory, no random draws)."""
    tree = init_params(cfg, torch.Generator(), device="meta", dtype=dtype)
    total = 0

    def add(t: torch.Tensor) -> None:
        nonlocal total
        total += t.numel() * t.element_size()

    tree_map(add, tree)
    return total


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


# ===================================================================== #
# embed / unembed
# ===================================================================== #
def _embed_tokens(p: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    if cfg.n_codebooks > 1:
        # tokens (B, S, K): sum of per-codebook embeddings (MusicGen)
        offs = torch.arange(cfg.n_codebooks, dtype=tokens.dtype,
                            device=tokens.device) * cfg.vocab
        x = nn.embed(p["embed"], tokens + offs[None, None, :])
        return x.sum(dim=2)
    return nn.embed(p["embed"], tokens)


def _logits(p: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        out = h @ p["embed"]["table"].t().to(h.dtype)
    else:
        out = nn.dense(p["lm_head"], h)
    if cfg.n_codebooks > 1:
        out = out.reshape(out.shape[:-1] + (cfg.n_codebooks, cfg.vocab))
    return out


# ===================================================================== #
# forward / loss
# ===================================================================== #
def _hidden(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor], patch_embeds: Optional[torch.Tensor],
            impl: str, remat: bool, remat_policy) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embeddings (the vision stub's patches first) through every stack
    and the final norm → ``(h, aux)``."""
    B, S = tokens.shape[:2]
    x = _embed_tokens(p, cfg, tokens)
    if cfg.vision_stub and patch_embeds is not None:
        Np = patch_embeds.shape[1]
        patches = nn.dense(p["patch_proj"], patch_embeds.to(x.dtype))
        x = torch.cat([patches, x[:, Np:]], dim=1)
    if positions is None:
        pos1 = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        positions = torch.stack([pos1] * 3) if cfg.mrope else pos1
    h = x
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for sp, (pat, reps) in zip(p["stacks"], cfg.stacks):
        h, a = stack_fwd(sp, pat, reps, h, positions, impl=impl, remat=remat,
                         remat_policy=remat_policy)
        aux = aux + a
    return nn.rmsnorm(p["final_norm"], h), aux


def forward(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            patch_embeds: Optional[torch.Tensor] = None, impl: str = "chunked",
            remat: bool = False, remat_policy=None, last_only: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → ``(logits, aux_loss)``
    (``repro/models/model.py:128-160``).  ``tokens (B, S)`` or ``(B, S,
    K)``; ``positions (B, S)`` or ``(3, B, S)`` for M-RoPE;
    ``patch_embeds (B, Np, d)`` replace the first ``Np`` positions (the
    vision stub); ``last_only`` unembeds the final position only."""
    h, aux = _hidden(p, cfg, tokens, positions, patch_embeds, impl, remat, remat_policy)
    if last_only:
        h = h[:, -1:]
    return _logits(p, cfg, h), aux


def _ce_terms(logits_f32: torch.Tensor, labels: torch.Tensor, onehot: bool = False):
    """Per-token ``(nll, lse)`` for one chunk; ``onehot`` takes the label
    logit by a one-hot contraction instead of a gather."""
    lse = torch.logsumexp(logits_f32, dim=-1)
    if onehot:
        oh = F.one_hot(labels.long(), logits_f32.shape[-1]).to(logits_f32.dtype)
        ll = torch.einsum("...v,...v->...", oh, logits_f32)
    else:
        ll = logits_f32.gather(-1, labels.long()[..., None])[..., 0]
    return lse - ll, lse


def loss_fn(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            impl: str = "chunked", remat: bool = False, remat_policy=None,
            ce_chunk: int = 0, ce_onehot: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal LM loss: cross-entropy + z-loss + MoE aux →
    ``(total, {"ce", "z_loss", "aux"})`` (``repro/models/model.py:181-258``).

    ``ce_chunk > 0`` unembeds and scores the sequence in chunks of that
    many positions, each recomputed in backward, so the ``(B, S, V)``
    float32 logits never exist at once (its mean runs over every label;
    ``loss_mask`` is not read, as in JAX).
    """
    if ce_chunk:
        B, S = batch["tokens"].shape[:2]
        h, aux = _hidden(p, cfg, batch["tokens"], batch.get("positions"),
                         batch.get("patch_embeds"), impl, remat, remat_policy)
        labels = batch["labels"]

        def chunk(hc, lc):
            logits = _logits(p, cfg, hc).float()
            nll, lse = _ce_terms(logits, lc, onehot=ce_onehot)
            return nll.sum(), (lse ** 2).sum()

        nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        z_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(S // ce_chunk):
            sl = slice(i * ce_chunk, (i + 1) * ce_chunk)
            n, z = checkpoint(chunk, h[:, sl], labels[:, sl], use_reentrant=False)
            nll_sum = nll_sum + n
            z_sum = z_sum + z
        denom = torch.tensor(float(np_prod_shape(labels.shape)), dtype=torch.float32)
        ce = nll_sum / denom
        zl = cfg.z_loss * z_sum / denom
        total = ce + zl + cfg.aux_loss_weight * aux
        return total, {"ce": ce, "z_loss": zl, "aux": aux}

    logits, aux = forward(p, cfg, batch["tokens"], positions=batch.get("positions"),
                          patch_embeds=batch.get("patch_embeds"), impl=impl,
                          remat=remat, remat_policy=remat_policy)
    labels = batch["labels"]  # (B, S) or (B, S, K)
    nll, lse = _ce_terms(logits.float(), labels, onehot=ce_onehot)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(nll.shape, dtype=torch.float32, device=nll.device)
    else:
        mask = mask.reshape(tuple(mask.shape) + (1,) * (nll.dim() - mask.dim()))
        mask = mask.expand(nll.shape).float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    ce = (nll * mask).sum() / denom
    zl = cfg.z_loss * ((lse ** 2) * mask).sum() / denom
    total = ce + zl + cfg.aux_loss_weight * aux
    return total, {"ce": ce, "z_loss": zl, "aux": aux}


def np_prod_shape(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out
