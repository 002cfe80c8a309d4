"""tinyllama-1.1b — dense llama2-style, 22L, d=2048, 32H (GQA kv=4),
d_ff=5632, vocab=32000 [arXiv:2401.02385].

Counterpart of ``repro/configs/tinyllama_1_1b.py`` with the same numbers.
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
        name="tinyllama-1.1b",
        family="dense",
        d_model=d_model,
        vocab=vocab,
        stacks=(((block,), n_layers),),
    )


def config() -> ModelConfig:
    return _cfg(22, 2048, 32, 4, 5632, 32000, head_dim=64)


def smoke_config() -> ModelConfig:
    return _cfg(2, 64, 8, 2, 176, 256, head_dim=8)
