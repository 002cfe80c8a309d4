"""Minimal NN substrate of the port (counterpart of ``repro/models/nn.py``).

Parameters are plain nested dicts of tensors that mirror the JAX
package's pytrees leaf for leaf.  Every layer is a pair of functions:
``*_init(generator, ...) -> params`` and a pure ``apply``.  Initializers
draw from an explicit ``torch.Generator`` on its own device and move the
result to ``device``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

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
    """``x @ w (+ b)``.  Operands of two dtypes compute in their promoted
    dtype, as JAX's ``@`` does (torch's refuses them); the bias's sum
    promotes alike."""
    w = p["w"]
    if dtype is None and w.dtype != x.dtype:
        dtype = torch.promote_types(x.dtype, w.dtype)
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


def _const(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as JAX rounds a weak-typed constant."""
    return torch.tensor(v, dtype=dtype).item()


def silu(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``jax.nn.silu``, ``x · (1 / (1 + e^-x))``.  Below float32 every
    step rounds to ``x``'s type, as XLA computes it in eager and jitted
    code alike; ``F.silu`` rounds once and differs from it in 5% of the
    bfloat16 inputs.  Float32 stays ``F.silu``."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``jax.nn.gelu(x, approximate=True)``.  Below float32 every step
    rounds to ``x``'s type, its constants too, as XLA computes it (``F.gelu``
    differs in 4% of the bfloat16 inputs).  Float32 stays ``F.gelu``."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    c = _const(math.sqrt(2 / math.pi), x.dtype)
    cube = x * x * x
    return x * (0.5 * (1.0 + torch.tanh(c * (x + _const(0.044715, x.dtype) * cube))))


def layernorm_init(d: int, *, dtype=torch.float32, device="cuda") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(dt)


# --------------------------------------------------------------------- #
# trees: dicts, lists, tuples (NamedTuples too) and None, flattened in the
# order of ``jax.tree_util`` (dict keys sorted, None holds no leaf)
# --------------------------------------------------------------------- #
def _children(tree: Any, path: str):
    """``(key, path, child)`` of a node in JAX's flatten order, or None
    for a leaf."""
    def join(key: str) -> str:
        return f"{path}/{key}" if path else key

    if isinstance(tree, dict):
        return [(k, join(f"[{k!r}]"), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(k, join(f".{k}"), getattr(tree, k)) for k in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(i, join(f"[{i}]"), v) for i, v in enumerate(tree)]
    return None


def tree_leaves_with_path(tree: Any, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, leaf)`` pairs in JAX's flatten order; a path is the
    ``"/"``-joined keys as ``jax.tree_util`` prints them (``['w']``,
    ``[0]``, ``.m`` for a NamedTuple field)."""
    if tree is None:
        return []
    kids = _children(tree, path)
    if kids is None:
        return [(path, tree)]
    return [leaf for _, p, v in kids for leaf in tree_leaves_with_path(v, p)]


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` on every leaf; structure and None kept."""
    if tree is None:
        return None
    kids = _children(tree, path)
    if kids is None:
        return fn(path, tree)
    out = {k: tree_map_with_path(fn, v, p) for k, p, v in kids}
    if isinstance(tree, dict):
        return {k: out[k] for k in tree}  # the caller's key order
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(**out)
    return type(tree)(out[i] for i in range(len(tree)))


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    return [x for _, x in tree_leaves_with_path(tree)]


def tree_unflatten(like: Any, leaves: Sequence[Any]) -> Any:
    """A tree shaped like ``like`` whose leaves are ``leaves``, in JAX's
    flatten order."""
    it = iter(leaves)
    return tree_map_with_path(lambda _path, _x: next(it), like)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure); structure and None kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_signature(tree: Any) -> str:
    """The structure of a tree without its leaves: nested keys, list
    lengths, NamedTuple fields and Nones (the port's treedef)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {tree_signature(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree).__name__ + "(" + ", ".join(
            f"{k}={tree_signature(getattr(tree, k))}" for k in tree._fields) + ")"
    if isinstance(tree, (list, tuple)):
        body = ", ".join(tree_signature(v) for v in tree)
        return f"[{body}]" if isinstance(tree, list) else f"({body})"
    return "*"


# --------------------------------------------------------------------- #
# misc
# --------------------------------------------------------------------- #
def count_params(params: Params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def param_bytes(params: Params) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))


def cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)
