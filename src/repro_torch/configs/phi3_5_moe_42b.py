"""phi3.5-moe-42b-a6.6b — MoE, 32L, d=4096, 32H (GQA kv=8),
16 experts top-2 with expert d_ff=6400, vocab=32064
[hf:microsoft/Phi-3.5-MoE-instruct].

Counterpart of ``repro/configs/phi3_5_moe_42b.py`` with the same numbers.
At 32 layers the model is 167 GB in float32 (84 GB in bf16), more than
one 80 GB card holds; a run on one card cuts the depth with
``dataclasses.replace(cfg, stacks=((pattern, n),))``.
"""

from repro_torch.models.attention import AttnConfig
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoeConfig
from repro_torch.models.transformer import BlockSpec


def _cfg(n_layers, d_model, n_heads, n_kv, d_ff_expert, vocab, head_dim,
         n_experts=16, top_k=2, capacity_factor=1.25):
    attn = AttnConfig(
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv, head_dim=head_dim
    )
    block = BlockSpec(
        kind="attn",
        attn=attn,
        moe=MoeConfig(n_experts=n_experts, top_k=top_k, d_ff_expert=d_ff_expert,
                      capacity_factor=capacity_factor),
    )
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        d_model=d_model,
        vocab=vocab,
        stacks=(((block,), n_layers),),
    )


def config() -> ModelConfig:
    return _cfg(32, 4096, 32, 8, 6400, 32064, head_dim=128)


def smoke_config() -> ModelConfig:
    # drop-free capacity, as the JAX smoke config
    return _cfg(2, 64, 4, 2, 128, 256, head_dim=16, n_experts=4, top_k=2,
                capacity_factor=8.0)
