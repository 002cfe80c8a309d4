"""chatglm3-6b — dense, 28L, d=4096, 32H (GQA kv=2), d_ff=13696,
vocab=65024, 2d-RoPE (rotary on half the head dims) [arXiv:2406.12793; hf].

Counterpart of ``repro/configs/chatglm3_6b.py`` with the same numbers.
"""

from repro_torch.models.attention import AttnConfig
from repro_torch.models.model import ModelConfig
from repro_torch.models.transformer import BlockSpec


def _cfg(n_layers, d_model, n_heads, n_kv, d_ff, vocab, head_dim):
    attn = AttnConfig(
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        rope="rope2d",
        rotary_dim=head_dim // 2,
        qkv_bias=True,  # chatglm uses qkv bias
    )
    block = BlockSpec(kind="attn", attn=attn, d_ff=d_ff, ffn_kind="swiglu")
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        d_model=d_model,
        vocab=vocab,
        stacks=(((block,), n_layers),),
    )


def config() -> ModelConfig:
    return _cfg(28, 4096, 32, 2, 13696, 65024, head_dim=128)


def smoke_config() -> ModelConfig:
    return _cfg(2, 64, 4, 2, 172, 256, head_dim=16)
