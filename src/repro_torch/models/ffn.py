"""Feed-forward mixers: SwiGLU / GeGLU / plain-GELU MLP.

Counterpart of ``repro/models/ffn.py``; the ``kind`` is static
configuration, the param dict holds tensors only.
"""

from __future__ import annotations

import torch

from repro_torch.models import nn
from repro_torch.models.nn import Params


def init_ffn(generator: torch.Generator, d_model: int, d_ff: int,
             kind: str = "swiglu", dtype=torch.float32, device="cuda") -> Params:
    kw = dict(dtype=dtype, device=device)
    if kind in ("swiglu", "geglu"):
        return {
            "wi_gate": nn.dense_init(generator, d_model, d_ff, **kw),
            "wi_up": nn.dense_init(generator, d_model, d_ff, **kw),
            "wo": nn.dense_init(generator, d_ff, d_model, **kw),
        }
    if kind == "gelu":
        return {
            "wi": nn.dense_init(generator, d_model, d_ff, bias=True, **kw),
            "wo": nn.dense_init(generator, d_ff, d_model, bias=True, **kw),
        }
    raise ValueError(f"unknown ffn kind {kind!r}")


def ffn_fwd(p: Params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    if kind == "swiglu":
        return nn.dense(p["wo"], nn.silu(nn.dense(p["wi_gate"], x)) * nn.dense(p["wi_up"], x))
    if kind == "geglu":
        return nn.dense(
            p["wo"],
            nn.gelu_tanh(nn.dense(p["wi_gate"], x)) * nn.dense(p["wi_up"], x),
        )
    return nn.dense(p["wo"], nn.gelu_tanh(nn.dense(p["wi"], x)))
