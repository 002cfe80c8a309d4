"""Attention mixers of the port (counterpart of ``repro/models/attention.py``).

GQA and MHA, every rope variant, windowed or not:

* :class:`AttnConfig`, the cos/sin tables and rotation
  (:func:`make_cos_sin`, :func:`_rotate`) and :func:`init_gqa` for the
  port's own weights;
* the training forward: :func:`gqa_fwd` through
  :func:`chunked_attention`, the online softmax over KV chunks that the
  JAX package runs in XLA (no Pallas kernel backs it, so it stays plain
  torch ops under autograd), dispatched by :func:`attention_fwd`;
* :func:`reference_attention`, the naive full-score attention, the
  oracle and ``impl="reference"``.

The serving engine's prefill runs the flash kernel
(``kernels.ops.flash_attention``) instead.  MLA and the dense-cache
decode are a later slice (ROADMAP Queue 1 item 7).
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


# ===================================================================== #
# chunked online-softmax attention (the training path)
# ===================================================================== #
DEFAULT_KV_CHUNK = 1024


def chunked_attention(
    q: torch.Tensor,  # (B, S, H, D) — queries (already rotated)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,  # (B, T, Hkv, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,  # absolute position of q[0] (prefill chunks)
    scale: Optional[float] = None,
    kv_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Blockwise attention with a running softmax (never builds S×T
    scores), the loop of ``repro/models/attention.py:107-174`` with its
    masks and guards: a fully masked row keeps ``m = -inf`` and takes
    ``m_safe = 0``, so no ``-inf - -inf`` reaches an ``exp`` whose
    gradient is used; the output divides by ``max(l, 1e-20)``.

    GQA folds the group dim into the batch of einsums, so KV is never
    materialized per query head.
    """
    B, S, H, D = q.shape
    T, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Hkv, G, D) * torch.tensor(scale, dtype=q.dtype)

    kv_chunk = kv_chunk or min(DEFAULT_KV_CHUNK, max(T, 16))
    nchunks = -(-T // kv_chunk)
    Tpad = nchunks * kv_chunk
    if Tpad != T:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, Tpad - T))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, Tpad - T))
    kc = k.reshape(B, nchunks, kv_chunk, Hkv, D)
    vc = v.reshape(B, nchunks, kv_chunk, Hkv, Dv)

    dev = q.device
    q_pos = q_offset + torch.arange(S, device=dev)  # (S,)
    m = torch.full((B, S, Hkv, G), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((B, S, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, S, Hkv, G, Dv), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for c in range(nchunks):
        kb, vb = kc[:, c], vc[:, c]
        k_pos = c * kv_chunk + torch.arange(kv_chunk, device=dev)  # (C,)
        s = torch.einsum("bshgd,bchd->bshgc", qg, kb)  # (B,S,Hkv,G,C)
        if causal:
            mask = k_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones((S, kv_chunk), dtype=torch.bool, device=dev)
        if window is not None:
            mask = mask & (k_pos[None, :] > (q_pos[:, None] - window))
        mask = mask & (k_pos < T)[None, :]  # padding
        mask5 = mask[None, :, None, None, :]
        s = torch.where(mask5, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new = -inf): exp(-inf - -inf) → nan
        m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask5, p, zero)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), zero)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bshgc,bchd->bshgd", p.to(vb.dtype), vb)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-20)
    return out.reshape(B, S, H, Dv).to(q.dtype)


def gqa_fwd(p: dict, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
            impl: str = "chunked") -> torch.Tensor:
    """Full-sequence causal GQA: ``x (B, S, d)``, ``positions (B, S)`` or
    ``(3, B, S)`` → ``(B, S, d)``."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = nn.dense(p["wq"], x).reshape(B, S, H, D)
    k = nn.dense(p["wk"], x).reshape(B, S, Hkv, D)
    v = nn.dense(p["wv"], x).reshape(B, S, Hkv, D)
    cos, sin = make_cos_sin(cfg, positions)
    if cos is not None:
        q = _rotate(cfg, q, cos, sin)
        k = _rotate(cfg, k, cos, sin)
    fn = chunked_attention if impl == "chunked" else reference_attention
    o = fn(q, k, v, causal=True, window=cfg.window)
    return nn.dense(p["wo"], o.reshape(B, S, H * D))


def attention_fwd(p: dict, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
                  impl: str = "chunked") -> torch.Tensor:
    if cfg.is_mla:
        raise NotImplementedError(
            "MLA attention is not ported yet: ROADMAP Queue 1 item 7, 'MLA and "
            "the SSM mixers'")
    return gqa_fwd(p, cfg, x, positions, impl=impl)
