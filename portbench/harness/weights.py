"""The served model: the port's configuration cut as the configuration file
says, and seeded weights made on the device in the tree the engine takes.

The tree's shapes come from a ``meta`` build of the port's own
``init_params`` (no memory, no draws).  Each leaf is drawn in one call
from a generator on the device, in the type it is served in: norms 1,
biases 0, the embedding, LM head and router N(0, 0.02²), every other
matrix N(0, 1/fan_in).  The reference gets the same tensors as a plain
list of layers (:func:`plain_layers`).
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Any, Dict, List, Tuple

import torch

# the configuration file's keys against the port's fields, checked equal
_ATTN_KEYS = (("num_attention_heads", "n_heads"), ("num_key_value_heads", "n_kv_heads"),
              ("head_dim", "head_dim"), ("rope_theta", "rope_base"))


def port_config(config: Dict[str, Any]):
    """The port's ``ModelConfig`` for a configuration file: the arch's
    published (or ``"preset": "smoke"``) config with the file's
    ``vocab_size``, cut to its ``num_hidden_layers`` and its
    ``capacity_factor``; raises where another number of the file differs
    from what the port would run (the norms' eps is ``nn.rmsnorm``'s, which
    no config changes)."""
    from repro_torch import configs
    from repro_torch.models import nn

    get = configs.get_smoke_config if config.get("preset") == "smoke" else configs.get_config
    cfg = get(config["arch"])
    ((pattern, _reps),) = cfg.stacks
    if len(pattern) != 1:
        raise ValueError(f"{config['arch']}: a one-block period is served here")
    spec = pattern[0]
    if "capacity_factor" in config:
        spec = dataclasses.replace(
            spec, moe=dataclasses.replace(spec.moe, capacity_factor=config["capacity_factor"]))
    cfg = dataclasses.replace(cfg, vocab=config["vocab_size"],
                              stacks=(((spec,), config["num_hidden_layers"]),))
    got = {"hidden_size": cfg.d_model, "vocab_size": cfg.vocab,
           "tie_word_embeddings": cfg.tie_embeddings,
           "rms_norm_eps": inspect.signature(nn.rmsnorm).parameters["eps"].default}
    got.update({k: getattr(spec.attn, f) for k, f in _ATTN_KEYS})
    if spec.moe is not None:
        got.update(num_local_experts=spec.moe.n_experts, num_experts_per_tok=spec.moe.top_k,
                   intermediate_size=spec.moe.d_ff_expert)
    else:
        got.update(intermediate_size=spec.d_ff)
    bad = {k: (config.get(k), v) for k, v in got.items() if config.get(k) != v}
    if spec.attn.window is not None or spec.attn.qkv_bias or spec.attn.rope != "rope":
        bad["attention"] = "windowed, biased or not plain RoPE"
    if bad:
        raise ValueError(f"{config['name']}: the file and the port differ: {bad}")
    return cfg


def _walk(tree: Any, path: Tuple = ()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _set(tree: Any, path: Tuple, value: torch.Tensor) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _std(path: Tuple, shape: Tuple[int, ...]) -> float:
    if path[:2] in (("embed", "table"), ("lm_head", "w")) or "router" in path:
        return 0.02
    return 1.0 / math.sqrt(shape[-2])


def make_params(cfg, seed: int, device, dtype=torch.float32) -> Dict[str, Any]:
    """Seeded weights in the tree ``init_params(cfg)`` builds; one draw
    from a generator on ``device`` a leaf, cast leaf by leaf to ``dtype``."""
    from repro_torch.models.model import init_params

    tree = init_params(cfg, torch.Generator(), device="meta")
    gen = torch.Generator(device=device).manual_seed(seed)
    for path, leaf in list(_walk(tree)):
        shape = tuple(leaf.shape)
        if path[-1] == "scale":
            t = torch.ones(shape, dtype=dtype, device=device)
        elif path[-1] == "b":
            t = torch.zeros(shape, dtype=dtype, device=device)
        else:
            t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
            t.mul_(_std(path, shape))
            if dtype != torch.float32:
                t = t.to(dtype)
        _set(tree, path, t)
    return tree


def plain_layers(params: Dict[str, Any], n_layers: int) -> Dict[str, Any]:
    """The same tensors for the reference: embedding, final norm, LM head
    and one dict a layer (views of the stacked leaves)."""
    blk = params["stacks"][0]["blocks"][0]
    layers: List[Dict[str, Any]] = []
    for li in range(n_layers):
        a = blk["attn"]
        lay = {"norm1": blk["norm1"]["scale"][li], "norm2": blk["norm2"]["scale"][li],
               "wq": a["wq"]["w"][li], "wk": a["wk"]["w"][li],
               "wv": a["wv"]["w"][li], "wo": a["wo"]["w"][li]}
        if "moe" in blk:
            m = blk["moe"]
            lay.update(router=m["router"]["w"][li], e_gate=m["wi_gate"][li],
                       e_up=m["wi_up"][li], e_down=m["wo"][li])
        else:
            f = blk["ffn"]
            lay.update(f_gate=f["wi_gate"]["w"][li], f_up=f["wi_up"]["w"][li],
                       f_down=f["wo"]["w"][li])
        layers.append(lay)
    return {"embed": params["embed"]["table"], "final_norm": params["final_norm"]["scale"],
            "lm_head": params["lm_head"]["w"], "layers": layers}
