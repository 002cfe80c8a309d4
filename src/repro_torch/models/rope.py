"""Rotary position embeddings: standard, partial/2d (ChatGLM), M-RoPE (Qwen2-VL).

Counterpart of ``repro/models/rope.py``.  All variants rotate pairs
``(x0, x1) -> (x0·cos − x1·sin, x0·sin + x1·cos)`` with per-dimension
frequencies ``θ_i = base^(−2i/d)``; they differ in *which* dims rotate
and *which* position index feeds each frequency group:

* ``rope``        — full rotary over head_dim.
* ``rope_2d``     — only the first ``rotary_dim`` dims rotate.
* ``mrope``       — head_dim frequency groups split into (temporal,
  height, width) sections, each driven by its own position id; text
  tokens carry t=h=w, so M-RoPE degenerates to standard RoPE.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def rope_freqs(head_dim: int, base: float = 10000.0, device=None) -> torch.Tensor:
    """Inverse frequencies for each rotating dim pair: (head_dim//2,)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (base ** exps)


def rope_cos_sin(
    positions: torch.Tensor,  # (..., seq) int
    head_dim: int,
    base: float = 10000.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: (..., seq, head_dim//2) in fp32."""
    inv = rope_freqs(head_dim, base, device=positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(
    x: torch.Tensor,  # (..., seq, heads, head_dim)
    cos: torch.Tensor,  # (..., seq, head_dim//2)
    sin: torch.Tensor,
) -> torch.Tensor:
    """Rotate interleaved-half layout: x = [x1 | x2], pairs (x1_i, x2_i)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., :, None, :].to(x.dtype)
    s = sin[..., :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def apply_rope_partial(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    rotary_dim: int,
) -> torch.Tensor:
    """Rotate only the first ``rotary_dim`` dims (ChatGLM 2d-RoPE)."""
    xr, xp = x[..., :rotary_dim], x[..., rotary_dim:]
    half = rotary_dim // 2
    return torch.cat([apply_rope(xr, cos[..., :half], sin[..., :half]), xp], dim=-1)


# ------------------------------------------------------------------ #
# M-RoPE (Qwen2-VL)
# ------------------------------------------------------------------ #
def mrope_cos_sin(
    positions: torch.Tensor,  # (3, ..., seq) int — (t, h, w) ids
    head_dim: int,
    sections: Sequence[int] = (16, 24, 24),  # freq-group split, sums to half
    base: float = 10000.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sectioned cos/sin: each frequency block uses its own position id."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to {half}")
    inv = rope_freqs(head_dim, base, device=positions.device)
    ang = positions.float()[..., None] * inv  # (3, ..., S, half)
    owner = torch.repeat_interleave(
        torch.arange(len(sections), device=positions.device),
        torch.tensor(list(sections), device=positions.device),
    )
    ang_sel = torch.zeros(ang.shape[1:], dtype=ang.dtype, device=ang.device)
    for i in range(len(sections)):
        ang_sel = torch.where(owner == i, ang[i], ang_sel)
    return torch.cos(ang_sel), torch.sin(ang_sel)


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """For text-only streams t=h=w: stack to (3, ..., seq)."""
    return torch.stack([positions, positions, positions], dim=0)
