"""Minimal NN substrate of the port (counterpart of ``repro/models/nn.py``).

Parameters are plain nested dicts of tensors that mirror the JAX
package's pytrees leaf for leaf.  Every layer is a pair of functions:
``*_init(generator, ...) -> params`` and a pure ``apply``.  Initializers
draw from an explicit ``torch.Generator`` on its own device and move the
result to ``device``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch

Params = Dict[str, Any]


# --------------------------------------------------------------------- #
# initializers
# --------------------------------------------------------------------- #
def normal_init(generator: torch.Generator, shape: Sequence[int], std: float,
                dtype: torch.dtype, device) -> torch.Tensor:
    if torch.device(device).type == "meta":  # shapes only: nothing is drawn
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    x = torch.randn(tuple(shape), generator=generator, device=generator.device,
                    dtype=torch.float32)
    return x.mul_(std).to(device=device, dtype=dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               dtype=torch.float32, device="cuda", std: Optional[float] = None,
               bias: bool = False) -> Params:
    """Linear layer params. Default init: normal with fan-in std."""
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    p: Params = {"w": normal_init(generator, (d_in, d_out), std, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def embedding_init(generator: torch.Generator, vocab: int, d: int, *,
                   dtype=torch.float32, device="cuda", std: float = 0.02) -> Params:
    return {"table": normal_init(generator, (vocab, d), std, dtype, device)}


def rmsnorm_init(d: int, *, dtype=torch.float32, device="cuda") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #
def dense(p: Params, x: torch.Tensor, dtype=None) -> torch.Tensor:
    w = p["w"]
    if dtype is not None:
        w = w.to(dtype)
        x = x.to(dtype)
    y = x @ w
    if "b" in p:
        y = y + (p["b"].to(y.dtype) if dtype is not None else p["b"])
    return y


def embed(p: Params, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    t = p["table"]
    if dtype is not None:
        t = t.to(dtype)
    return t[ids.long()]


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)
