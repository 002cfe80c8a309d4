"""Attention mixers of the port (counterpart of ``repro/models/attention.py``).

GQA and MHA, every rope variant, windowed or not, and MLA
(DeepSeek-V2):

* :class:`AttnConfig`, the cos/sin tables and rotation
  (:func:`make_cos_sin`, :func:`_rotate`) and :func:`init_attention`
  (:func:`init_gqa` or :func:`init_mla`) for the port's own weights;
* the training forward: :func:`gqa_fwd` and :func:`mla_fwd` through
  :func:`chunked_attention`, the online softmax over KV chunks that the
  JAX package runs in XLA (no Pallas kernel backs it, so it stays plain
  torch ops under autograd), dispatched by :func:`attention_fwd`;
* the dense-cache decode: :func:`gqa_decode` (a full cache, or a rolling
  buffer of ``window`` slots) and :func:`mla_decode` (the absorbed
  decode over the ``(c_kv, k_rope)`` latent cache), einsums in XLA in
  JAX and plain torch ops here.  Each writes the new token's slot into
  the caches it is given, in place, and returns those same tensors;
* :func:`reference_attention`, the naive full-score attention, the
  oracle and ``impl="reference"``.

The serving engine's prefill runs the flash kernel
(``kernels.ops.flash_attention``) instead; MLA's q/k width (192) is not
its v width (128), so :func:`mla_fwd` stays on the chunked loop, as JAX.
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


def _cur_lens(cur_len, B: int, device) -> torch.Tensor:
    """``cur_len`` (an int, a scalar or ``(B,)``) → ``(B,)`` int64 on
    ``device``: the tokens each sequence already holds in its cache."""
    cur = torch.as_tensor(cur_len, device=device).to(torch.int64)
    return cur.reshape(-1).expand(B)


def gqa_decode(p: dict, cfg: AttnConfig, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, cur_len, positions: torch.Tensor,
               rolling: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step against a dense KV cache → ``(y, k_cache, v_cache)``
    (``repro/models/attention.py:236-288``).

    ``x (B, 1, d)``; caches ``(B, S_cache, Hkv, D)``; ``positions (B, 1)``
    or ``(3, B, 1)``.  The new token's rotated K and V go to slot ``cur``
    of each sequence (``cur % S_cache`` when ``rolling``: a windowed
    layer's buffer of ``window`` slots), written in place: the returned
    caches are the tensors passed in.  Scores in float32 over the valid
    slots: ``t <= cur`` (and ``t > cur - window``), or with ``rolling``
    the first ``min(cur + 1, S_cache)`` slots.
    """
    B = x.shape[0]
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S_cache = k_cache.shape[1]
    q = nn.dense(p["wq"], x).reshape(B, 1, H, D)
    k = nn.dense(p["wk"], x).reshape(B, 1, Hkv, D)
    v = nn.dense(p["wv"], x).reshape(B, 1, Hkv, D)
    cos, sin = make_cos_sin(cfg, positions)
    if cos is not None:
        q = _rotate(cfg, q, cos, sin)
        k = _rotate(cfg, k, cos, sin)
    cur = _cur_lens(cur_len, B, x.device)
    slot = torch.remainder(cur, S_cache) if rolling else cur
    bidx = torch.arange(B, device=x.device)
    k_cache[bidx, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v[:, 0].to(v_cache.dtype)

    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bhgd,bthd->bhgt", qg.float(), k_cache.float())
    t_pos = torch.arange(S_cache, device=x.device)[None, :]
    if rolling:
        # the buffer holds exactly the last min(cur + 1, S_cache) tokens
        valid = t_pos < torch.clamp_max(cur[:, None] + 1, S_cache)
    else:
        valid = t_pos <= cur[:, None]
        if cfg.window is not None:
            valid = valid & (t_pos > (cur[:, None] - cfg.window))
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgt,bthd->bhgd", pr, v_cache.float())
    o = o.reshape(B, 1, H * D).to(x.dtype)
    return nn.dense(p["wo"], o), k_cache, v_cache


# ===================================================================== #
# MLA (DeepSeek-V2)
# ===================================================================== #
def init_mla(generator: torch.Generator, cfg: AttnConfig, dtype=torch.float32,
             device="cuda") -> dict:
    """The tree of ``repro.models.attention.init_mla``: ``wq`` (no q
    compression), ``wkv_a`` (to the latent and the shared rope key),
    ``kv_norm``, ``wkv_b`` (latent to per-head k_nope and v), ``wo``."""
    d, H = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": nn.dense_init(generator, d, H * (dn + dr), **kw),
        "wkv_a": nn.dense_init(generator, d, r + dr, **kw),
        "kv_norm": nn.rmsnorm_init(r, **kw),
        "wkv_b": nn.dense_init(generator, r, H * (dn + dv), **kw),
        "wo": nn.dense_init(generator, H * dv, d, **kw),
    }


def _mla_qkv(p: dict, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor):
    """The shared projections → ``q_nope, q_rope, c_kv, k_rope`` (rotated):
    the latent through its rmsnorm, one rope key shared by every head
    (``(B, S, 1, dr)``)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    r, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = nn.dense(p["wq"], x).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    kv_a = nn.dense(p["wkv_a"], x)  # (B, S, r + dr)
    c_kv = nn.rmsnorm(p["kv_norm"], kv_a[..., :r])
    k_rope = kv_a[..., r:][:, :, None, :]
    cos, sin = rope_cos_sin(positions, dr, cfg.rope_base)
    return q_nope, apply_rope(q_rope, cos, sin), c_kv, apply_rope(k_rope, cos, sin)


def mla_fwd(p: dict, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
            impl: str = "chunked") -> torch.Tensor:
    """Training/prefill MLA (``repro/models/attention.py:323-335``): expand
    the latent to per-head keys and values and run causal attention with
    ``scale = 1/sqrt(dn + dr)``."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dv, dr = cfg.qk_nope_dim, cfg.v_head_dim, cfg.qk_rope_dim
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    kv = nn.dense(p["wkv_b"], c_kv).reshape(B, S, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    fn = chunked_attention if impl == "chunked" else reference_attention
    o = fn(q, k, v, causal=True, scale=1.0 / math.sqrt(dn + dr))
    return nn.dense(p["wo"], o.reshape(B, S, H * dv))


def mla_decode(p: dict, cfg: AttnConfig, x: torch.Tensor, ckv_cache: torch.Tensor,
               krope_cache: torch.Tensor, cur_len, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed decode → ``(y, ckv_cache, krope_cache)``
    (``repro/models/attention.py:338-385``): attention runs in the latent
    space,

        scores = (q_nope · W_kvb^K) · c_kv + q_rope · k_rope
        out    = W_o · (W_kvb^V · Σ p·c_kv)

    over the caches ``(B, S_max, r)`` and ``(B, S_max, dr)``, 576 elements
    a token at DeepSeek-V2-Lite's widths.  The new token's latent and
    rope key are written at ``cur`` in place.
    """
    B = x.shape[0]
    H = cfg.n_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    S_max = ckv_cache.shape[1]
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(p, cfg, x, positions)
    cur = _cur_lens(cur_len, B, x.device)
    bidx = torch.arange(B, device=x.device)
    ckv_cache[bidx, cur] = c_kv_new[:, 0].to(ckv_cache.dtype)
    krope_cache[bidx, cur] = k_rope_new[:, 0, 0, :].to(krope_cache.dtype)

    wkb = p["wkv_b"]["w"].reshape(r, H, dn + dv)
    w_k, w_v = wkb[..., :dn], wkb[..., dn:]  # (r, H, dn), (r, H, dv)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_k.float())
    s_lat = torch.einsum("bhr,btr->bht", q_lat, ckv_cache.float())
    s_rope = torch.einsum("bhd,btd->bht", q_rope[:, 0].float(), krope_cache.float())
    s = (s_lat + s_rope) / math.sqrt(dn + dr)
    valid = torch.arange(S_max, device=x.device)[None, :] <= cur[:, None]
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    pr = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bht,btr->bhr", pr, ckv_cache.float())  # (B, H, r)
    o = torch.einsum("bhr,rhd->bhd", o_lat, w_v.float())  # (B, H, dv)
    o = o.reshape(B, 1, H * dv).to(x.dtype)
    return nn.dense(p["wo"], o), ckv_cache, krope_cache


# ===================================================================== #
# dispatch
# ===================================================================== #
def init_attention(generator: torch.Generator, cfg: AttnConfig, dtype=torch.float32,
                   device="cuda") -> dict:
    if cfg.is_mla:
        return init_mla(generator, cfg, dtype, device)
    return init_gqa(generator, cfg, dtype, device)


def attention_fwd(p: dict, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
                  impl: str = "chunked") -> torch.Tensor:
    if cfg.is_mla:
        return mla_fwd(p, cfg, x, positions, impl=impl)
    return gqa_fwd(p, cfg, x, positions, impl=impl)
