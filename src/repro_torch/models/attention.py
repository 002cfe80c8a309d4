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
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.models import nn
from repro_torch.models.layout import batch_local, model_rank
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


def _gqa_core(cfg: AttnConfig, fn, kv_rank, q, k, v, cos, sin) -> torch.Tensor:
    """Heads, rope and attention of packed ``q (B, S, H·D)``, ``k``, ``v
    (B, S, Hkv·D)`` → ``(B, S, H·D)`` (a device's heads, on DTensors).
    Where this device holds ``H / tp`` query heads and every KV head,
    ``kv_rank`` (its index along ``model``) picks the KV heads of its
    query heads."""
    B, S = q.shape[:2]
    D = cfg.head_dim
    q, k, v = (t.reshape(B, S, -1, D) for t in (q, k, v))
    hq, hkv = q.shape[2], k.shape[2]
    if hq < cfg.n_heads and hkv == cfg.n_kv_heads:
        G = cfg.n_heads // cfg.n_kv_heads
        lo, hi = kv_rank * hq // G, ((kv_rank + 1) * hq - 1) // G + 1
        k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    if cos is not None:
        q = _rotate(cfg, q, cos, sin)
        k = _rotate(cfg, k, cos, sin)
    return fn(q, k, v, causal=True, window=cfg.window).reshape(B, S, -1)


def gqa_fwd(p: dict, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
            impl: str = "chunked") -> torch.Tensor:
    """Full-sequence causal GQA: ``x (B, S, d)``, ``positions (B, S)`` or
    ``(3, B, S)`` → ``(B, S, d)``.  On DTensors the heads, rope and
    attention run on each device's rows (and heads, when both head counts
    split over ``model``): ``layout.batch_local``."""
    D, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q, k, v = (nn.dense(p[w], x) for w in ("wq", "wk", "wv"))
    cos, sin = make_cos_sin(cfg, positions)
    fn = chunked_attention if impl == "chunked" else reference_attention
    rank, tp = model_rank(q)
    kv = (2, D)
    if H % tp == 0 and Hkv % tp and (H // Hkv) % (H // tp) == 0:
        kv = None  # query heads split, each device's KV heads picked in the core
    o = batch_local(functools.partial(_gqa_core, cfg, fn, rank), q, k, v, cos, sin,
                    heads=((2, D), kv, kv, None, None), out_heads=2)
    return nn.dense(p["wo"], o)


def _cur_lens(cur_len, B: int, device) -> torch.Tensor:
    """``cur_len`` (an int, a scalar or ``(B,)``) → ``(B,)`` int64 on
    ``device``: the tokens each sequence already holds in its cache."""
    cur = torch.as_tensor(cur_len, device=device).to(torch.int64)
    return cur.reshape(-1).expand(B)


def write_slot(cache: torch.Tensor, slot: torch.Tensor, new: torch.Tensor) -> None:
    """``cache[b, slot[b]] = new[b]`` for every sequence ``b``, in place."""
    bidx = torch.arange(cache.shape[0], device=cache.device)
    cache[bidx, slot] = new.to(cache.dtype)


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
    B, D = x.shape[0], cfg.head_dim
    q, k, v = (nn.dense(p[w], x) for w in ("wq", "wk", "wv"))
    cos, sin = make_cos_sin(cfg, positions)
    cur = _cur_lens(cur_len, B, x.device)
    o = batch_local(functools.partial(_gqa_decode_core, cfg, rolling), q, k, v, cos, sin,
                    k_cache, v_cache, cur,
                    heads=((2, D), (2, D), (2, D), None, None, 2, 2, None), out_heads=2,
                    writeback=(5, 6))
    return nn.dense(p["wo"], o.to(x.dtype)), k_cache, v_cache


def _gqa_decode_core(cfg: AttnConfig, rolling: bool, q, k, v, cos, sin, k_cache,
                     v_cache, cur) -> torch.Tensor:
    """The new token's heads and rope, its cache slots, attention over the
    caches → ``(B, 1, H·D)`` float32 (a device's rows and heads)."""
    B, D = q.shape[0], cfg.head_dim
    q, k, v = (t.reshape(B, 1, -1, D) for t in (q, k, v))
    if cos is not None:
        q = _rotate(cfg, q, cos, sin)
        k = _rotate(cfg, k, cos, sin)
    S_cache, Hkv = k_cache.shape[1], k_cache.shape[2]
    slot = torch.remainder(cur, S_cache) if rolling else cur
    write_slot(k_cache, slot, k[:, 0])
    write_slot(v_cache, slot, v[:, 0])

    qg = q.reshape(B, Hkv, -1, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bhgd,bthd->bhgt", qg.float(), k_cache.float())
    t_pos = torch.arange(S_cache, device=q.device)[None, :]
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
    return o.reshape(B, 1, -1)


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


def _mla_proj(p: dict, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor):
    """The shared projections → packed ``q (B, S, H·(dn+dr))``, the latent
    ``c_kv`` through its rmsnorm, the unrotated rope key ``(B, S, dr)``
    shared by every head, and rope's ``cos, sin``."""
    r = cfg.kv_lora_rank
    q = nn.dense(p["wq"], x)
    kv_a = nn.dense(p["wkv_a"], x)  # (B, S, r + dr)
    c_kv = nn.rmsnorm(p["kv_norm"], kv_a[..., :r])
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_dim, cfg.rope_base)
    return q, c_kv, kv_a[..., r:], cos, sin


def _mla_rope(cfg: AttnConfig, q, k_rope, cos, sin):
    """``q_nope, q_rope`` of packed ``q`` (heads split out) and the shared
    rope key ``(B, S, 1, dr)``, both rotated."""
    B, S = q.shape[:2]
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = q.reshape(B, S, -1, dn + dr)
    return (q[..., :dn], apply_rope(q[..., dn:], cos, sin),
            apply_rope(k_rope[:, :, None, :], cos, sin))


def mla_fwd(p: dict, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
            impl: str = "chunked") -> torch.Tensor:
    """Training/prefill MLA (``repro/models/attention.py:323-335``): expand
    the latent to per-head keys and values and run causal attention with
    ``scale = 1/sqrt(dn + dr)``."""
    dn, dv, dr = cfg.qk_nope_dim, cfg.v_head_dim, cfg.qk_rope_dim
    q, c_kv, k_rope, cos, sin = _mla_proj(p, cfg, x, positions)
    kv = nn.dense(p["wkv_b"], c_kv)  # (B, S, H·(dn+dv))
    fn = chunked_attention if impl == "chunked" else reference_attention
    o = batch_local(functools.partial(_mla_core, cfg, fn), q, kv, k_rope, cos, sin,
                    heads=((2, dn + dr), (2, dn + dv), None, None, None), out_heads=2)
    return nn.dense(p["wo"], o)


def _mla_core(cfg: AttnConfig, fn, q, kv, k_rope, cos, sin) -> torch.Tensor:
    """Per-head keys and values from the expanded latent, causal attention
    → ``(B, S, H·dv)`` (a device's rows and heads, on DTensors)."""
    B, S = q.shape[:2]
    dn, dv, dr = cfg.qk_nope_dim, cfg.v_head_dim, cfg.qk_rope_dim
    q_nope, q_rope, k_rope = _mla_rope(cfg, q, k_rope, cos, sin)
    kv = kv.reshape(B, S, -1, dn + dv)
    H = kv.shape[2]
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    o = fn(q, k, v, causal=True, scale=1.0 / math.sqrt(dn + dr))
    return o.reshape(B, S, H * dv)


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
    q, c_kv_new, k_rope_new, cos, sin = _mla_proj(p, cfg, x, positions)
    cur = _cur_lens(cur_len, x.shape[0], x.device)
    o = batch_local(functools.partial(_mla_decode_core, cfg), q, c_kv_new, k_rope_new,
                    cos, sin, ckv_cache, krope_cache, cur, params=p["wkv_b"]["w"],
                    writeback=(5, 6))
    return nn.dense(p["wo"], o.to(x.dtype)), ckv_cache, krope_cache


def _mla_decode_core(cfg: AttnConfig, w_kvb, q, c_kv_new, k_rope_new, cos, sin,
                     ckv_cache, krope_cache, cur) -> torch.Tensor:
    """Rope, the new token's latent slots, attention in the latent space →
    ``(B, 1, H·dv)`` float32 (a device's rows, on DTensors)."""
    B = q.shape[0]
    H = cfg.n_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    S_max = ckv_cache.shape[1]
    q_nope, q_rope, k_rope_new = _mla_rope(cfg, q, k_rope_new, cos, sin)
    write_slot(ckv_cache, cur, c_kv_new[:, 0])
    write_slot(krope_cache, cur, k_rope_new[:, 0, 0, :])

    wkb = w_kvb.reshape(r, H, dn + dv)
    w_k, w_v = wkb[..., :dn], wkb[..., dn:]  # (r, H, dn), (r, H, dv)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_k.float())
    s_lat = torch.einsum("bhr,btr->bht", q_lat, ckv_cache.float())
    s_rope = torch.einsum("bhd,btd->bht", q_rope[:, 0].float(), krope_cache.float())
    s = (s_lat + s_rope) / math.sqrt(dn + dr)
    valid = torch.arange(S_max, device=q.device)[None, :] <= cur[:, None]
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    pr = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bht,btr->bhr", pr, ckv_cache.float())  # (B, H, r)
    o = torch.einsum("bhr,rhd->bhd", o_lat, w_v.float())  # (B, H, dv)
    return o.reshape(B, 1, H * dv)


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
