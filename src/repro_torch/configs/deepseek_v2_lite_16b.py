"""deepseek-v2-lite-16b — MoE with MLA, 27L, d=2048, 16H,
MLA kv_lora=512 (qk_nope=128, qk_rope=64, v_head=128), vocab=102400;
layer 0 is dense (d_ff=10944), layers 1-26 are MoE with 64 routed
experts top-6 + 2 shared experts, expert d_ff=1408 [arXiv:2405.04434].

Counterpart of ``repro/configs/deepseek_v2_lite_16b.py`` with the same
numbers.  The MLA latent cache is 576 elements a token.  At 27 layers
the model is 15.71 G parameters, 62.8 GB in float32: it fits one 80 GB
card for the forward and ``decode_step``, not for AdamW training, which
a run on one card cuts in depth.  The serving engine pages GQA caches
only and refuses MLA, as JAX's does.
"""

from repro_torch.models.attention import AttnConfig
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoeConfig
from repro_torch.models.transformer import BlockSpec


def _cfg(n_moe_layers, d_model, n_heads, vocab, kv_lora, d_ff_dense,
         d_ff_expert, n_experts=64, top_k=6, n_shared=2,
         qk_nope=128, qk_rope=64, v_head=128, capacity_factor=1.25):
    attn = AttnConfig(
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_heads,
        head_dim=qk_nope + qk_rope,
        kv_lora_rank=kv_lora,
        qk_nope_dim=qk_nope,
        qk_rope_dim=qk_rope,
        v_head_dim=v_head,
    )
    dense0 = BlockSpec(kind="attn", attn=attn, d_ff=d_ff_dense, ffn_kind="swiglu")
    moe = BlockSpec(
        kind="attn",
        attn=attn,
        moe=MoeConfig(
            n_experts=n_experts,
            top_k=top_k,
            d_ff_expert=d_ff_expert,
            n_shared=n_shared,
            d_ff_shared=n_shared * d_ff_expert,
            capacity_factor=capacity_factor,
        ),
    )
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        d_model=d_model,
        vocab=vocab,
        stacks=(((dense0,), 1), ((moe,), n_moe_layers)),
    )


def config() -> ModelConfig:
    return _cfg(26, 2048, 16, 102400, kv_lora=512, d_ff_dense=10944,
                d_ff_expert=1408)  # 27 layers


def smoke_config() -> ModelConfig:
    # drop-free capacity so fwd-vs-decode parity is exact in tests
    return _cfg(1, 64, 4, 256, kv_lora=32, d_ff_dense=128, d_ff_expert=64,
                n_experts=8, top_k=2, n_shared=1,
                qk_nope=16, qk_rope=8, v_head=16, capacity_factor=8.0)
