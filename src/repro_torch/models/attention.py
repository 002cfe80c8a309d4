"""Attention helpers of the port (counterpart of ``repro/models/attention.py``).

This slice carries what the tiered-KV serving engine calls: the
:class:`AttnConfig` dataclass, the cos/sin tables and rotation
(:func:`make_cos_sin`, :func:`_rotate`) and :func:`init_gqa` for the
port's own weights.  Prefill attention runs the flash kernel
(``kernels.ops.flash_attention``); :func:`reference_attention` is the
naive full-score attention in the model's ``(B, S, H, D)`` layout that
the JAX package's ``attention_fwd`` and dense decode also take, kept for
their ports.  The chunked training path, the dense-cache decode and MLA
are later slices (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.models import nn
from repro_torch.models.rope import (
    apply_rope,
    apply_rope_partial,
    mrope_cos_sin,
    rope_cos_sin,
    text_mrope_positions,
)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope: str = "rope"  # rope | rope2d | mrope | none
    rope_base: float = 10000.0
    rotary_dim: Optional[int] = None  # for rope2d (defaults head_dim//2)
    window: Optional[int] = None  # sliding-window size (None = full)
    qkv_bias: bool = False
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    # MLA (None fields → GQA)
    kv_lora_rank: Optional[int] = None
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank is not None

    @property
    def kv_cache_width(self) -> int:
        """Per-token KV cache width in elements (drives page sizing)."""
        if self.is_mla:
            return self.kv_lora_rank + self.qk_rope_dim
        return 2 * self.n_kv_heads * self.head_dim


def make_cos_sin(cfg: AttnConfig, positions: torch.Tensor):
    """positions: (B, S) int, or (3, B, S) for mrope."""
    if cfg.rope == "none":
        return None, None
    if cfg.rope == "mrope":
        if positions.dim() == 2:  # text-only: t=h=w
            positions = text_mrope_positions(positions)
        return mrope_cos_sin(positions, cfg.head_dim, cfg.mrope_sections, cfg.rope_base)
    if cfg.rope == "rope2d":
        rd = cfg.rotary_dim or cfg.head_dim // 2
        return rope_cos_sin(positions, rd, cfg.rope_base)
    dim = cfg.qk_rope_dim if cfg.is_mla else cfg.head_dim
    return rope_cos_sin(positions, dim, cfg.rope_base)


def _rotate(cfg: AttnConfig, x: torch.Tensor, cos, sin) -> torch.Tensor:
    if cfg.rope == "none":
        return x
    if cfg.rope == "rope2d":
        rd = cfg.rotary_dim or cfg.head_dim // 2
        return apply_rope_partial(x, cos, sin, rd)
    return apply_rope(x, cos, sin)


def init_gqa(generator: torch.Generator, cfg: AttnConfig, dtype=torch.float32,
             device="cuda") -> dict:
    d, H, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": nn.dense_init(generator, d, H * D, bias=cfg.qkv_bias, **kw),
        "wk": nn.dense_init(generator, d, Hkv * D, bias=cfg.qkv_bias, **kw),
        "wv": nn.dense_init(generator, d, Hkv * D, bias=cfg.qkv_bias, **kw),
        "wo": nn.dense_init(generator, H * D, d, **kw),
    }


def reference_attention(
    q, k, v, *, causal=True, window=None, q_offset=0, scale=None
) -> torch.Tensor:
    """Naive full-score attention (prefill; fine for short S).

    q: (B, S, H, D); k, v: (B, T, Hkv, D[v]) → (B, S, H, Dv) in q's type.
    """
    B, S, H, D = q.shape
    T, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Hkv, G, D).float() * scale
    s = torch.einsum("bshgd,bthd->bshgt", qg, k.float())
    q_pos = q_offset + torch.arange(S, device=q.device)
    k_pos = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > (q_pos[:, None] - window)
    s = s.masked_fill(~mask[None, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    out = torch.einsum("bshgt,bthd->bshgd", p, v.float())
    return out.reshape(B, S, H, Dv).to(q.dtype)
