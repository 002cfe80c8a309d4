"""musicgen-medium — decoder-only over EnCodec tokens, 48L, d=1536,
24H (MHA), d_ff=6144, vocab=2048 per codebook × 4 codebooks
[arXiv:2306.05284].

Backbone only per the assignment: the audio frontend is a stub —
``input_specs()`` supplies precomputed EnCodec token ids (B, S, 4); the
delay-pattern interleaving lives in the data pipeline, not the model.

Counterpart of ``repro/configs/musicgen_medium.py`` with the same
numbers.  The serving engine, like the JAX one, serves one token stream
over the ``vocab × n_codebooks`` embedding table, and its greedy argmax
runs over ``vocab × n_codebooks`` logits.
"""

from repro_torch.models.attention import AttnConfig
from repro_torch.models.model import ModelConfig
from repro_torch.models.transformer import BlockSpec


def _cfg(n_layers, d_model, n_heads, d_ff, vocab, head_dim, n_codebooks=4):
    attn = AttnConfig(
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads, head_dim=head_dim
    )
    block = BlockSpec(kind="attn", attn=attn, d_ff=d_ff, ffn_kind="gelu")
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        d_model=d_model,
        vocab=vocab,
        stacks=(((block,), n_layers),),
        n_codebooks=n_codebooks,
    )


def config() -> ModelConfig:
    return _cfg(48, 1536, 24, 6144, 2048, head_dim=64)


def smoke_config() -> ModelConfig:
    return _cfg(2, 64, 4, 192, 128, head_dim=16, n_codebooks=2)
