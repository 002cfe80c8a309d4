"""Operations and bytes of the served model, counted from shapes, and the
card's peaks: the yardstick of the roofline and MFU metrics.

Arithmetic copied from ``chip_smoke.py`` (``attn_work``, ``flash_work``,
``bound``; peaks from NVIDIA's H100 SXM data sheet).  Each input byte is
counted once and only the valid token slots; MoE products count the
``k`` experts a token is routed to, not the ``E x C`` slots the port
computes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
# dense peaks by input type: float32 outside the tensor cores, bfloat16 on them
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def bound_s(nbytes: float, flops: float, dtype: str = "float32") -> float:
    """Least seconds for ``nbytes`` of HBM traffic and ``flops`` on inputs
    of ``dtype``: the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


@dataclasses.dataclass(frozen=True)
class Shapes:
    """The widths of the served model, from its configuration file."""

    d: int
    heads: int
    kv_heads: int
    head_dim: int
    layers: int
    vocab: int
    d_ff: int = 0  # dense SwiGLU width
    experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    page_size: int = 16
    kv_itemsize: int = 4  # the KV store is float32

    @classmethod
    def of(cls, config: dict, page_size: int) -> "Shapes":
        return cls(
            d=config["hidden_size"], heads=config["num_attention_heads"],
            kv_heads=config["num_key_value_heads"], head_dim=config["head_dim"],
            layers=config["num_hidden_layers"], vocab=config["vocab_size"],
            d_ff=config.get("intermediate_size", 0) if "num_local_experts" not in config else 0,
            experts=config.get("num_local_experts", 0),
            top_k=config.get("num_experts_per_tok", 0),
            d_ff_expert=config.get("intermediate_size", 0) if "num_local_experts" in config else 0,
            page_size=page_size,
        )

    def layer_matmul_flops(self) -> float:
        """One token through one layer's products: q, k, v, o and the FFN
        (the router and ``top_k`` experts for an MoE)."""
        hd = self.heads * self.head_dim
        attn = 2.0 * self.d * (hd + 2 * self.kv_heads * self.head_dim) + 2.0 * hd * self.d
        if self.experts:
            ffn = 2.0 * self.d * self.experts + self.top_k * 6.0 * self.d * self.d_ff_expert
        else:
            ffn = 6.0 * self.d * self.d_ff
        return attn + ffn


def attended_tokens(pos: int, page_size: int, topk: int, recent: int) -> int:
    """Token slots a decode step at position ``pos`` attends: the full
    older pages top-k picks, the recent pages' written slots and the new
    token itself (the engine's ``_select_pages`` plus its write page)."""
    n = -(-pos // page_size)  # pages holding positions < pos
    older = max(0, n - recent)
    return min(topk, older) * page_size + (pos - older * page_size) + 1


def decode_step_work(sh: Shapes, positions: Sequence[int], topk: int,
                     recent: int) -> Dict[str, float]:
    """Model FLOPs of one decode step over lanes at ``positions`` and the
    bytes its ``paged_attention`` launches need (all layers)."""
    n_att = [attended_tokens(p, sh.page_size, topk, recent) for p in positions]
    B, A = len(positions), sum(n_att)
    hd = sh.heads * sh.head_dim
    flops = (B * sh.layers * sh.layer_matmul_flops()
             + sh.layers * 4.0 * hd * A  # q.k and p.v over the attended slots
             + B * 2.0 * sh.d * sh.vocab)  # the LM head
    kv_bytes = A * 2 * sh.kv_heads * sh.head_dim * sh.kv_itemsize
    qo_bytes = 2 * B * hd * 4
    return {"flops": flops, "pa_bytes": sh.layers * (kv_bytes + qo_bytes),
            "pa_flops": sh.layers * 4.0 * hd * A}


def flash_work(sh: Shapes, S: int) -> Dict[str, float]:
    """One ``flash_attention`` launch over ``S`` causal positions: q, k, v
    read and the output written once; 4·D FLOPs a query-key pair."""
    hd = sh.heads * sh.head_dim
    kvd = sh.kv_heads * sh.head_dim
    nbytes = (2 * S * hd + 2 * S * kvd) * 4
    flops = 4.0 * sh.head_dim * sh.heads * S * (S + 1) / 2
    return {"bytes": nbytes, "flops": flops}


def prefill_work(sh: Shapes, prompt_len: int) -> Dict[str, float]:
    """A prompt's prefill (``prompt_len - 1`` positions, no LM head): model
    FLOPs, and the least seconds of its ``flash_attention`` launches."""
    S = prompt_len - 1
    if S <= 0:
        return {"flops": 0.0, "flash_bound_s": 0.0}
    fw = flash_work(sh, S)
    return {"flops": S * sh.layers * sh.layer_matmul_flops() + sh.layers * fw["flops"],
            "flash_bound_s": sh.layers * bound_s(fw["bytes"], fw["flops"])}
