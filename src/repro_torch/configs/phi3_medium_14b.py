"""phi3-medium-14b — dense, 40L, d=5120, 40H (GQA kv=10), d_ff=17920,
vocab=100352, RoPE + SwiGLU [arXiv:2404.14219].

Counterpart of ``repro/configs/phi3_medium_14b.py`` with the same numbers.
"""

from repro_torch.models.attention import AttnConfig
from repro_torch.models.model import ModelConfig
from repro_torch.models.transformer import BlockSpec


def _cfg(n_layers, d_model, n_heads, n_kv, d_ff, vocab, head_dim):
    attn = AttnConfig(
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv, head_dim=head_dim
    )
    block = BlockSpec(kind="attn", attn=attn, d_ff=d_ff, ffn_kind="swiglu")
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        d_model=d_model,
        vocab=vocab,
        stacks=(((block,), n_layers),),
    )


def config() -> ModelConfig:
    return _cfg(40, 5120, 40, 10, 17920, 100352, head_dim=128)


def smoke_config() -> ModelConfig:
    return _cfg(2, 80, 4, 2, 256, 256, head_dim=20)
