"""qwen2-vl-2b — VLM backbone, 28L, d=1536, 12H (GQA kv=2), d_ff=8960,
vocab=151936, M-RoPE, tied embeddings [arXiv:2409.12191].

Backbone only per the assignment: the vision tower is a stub —
``input_specs()`` supplies precomputed patch embeddings (B, 256, d) that
replace the first 256 token positions, plus (3, B, S) M-RoPE position
ids (t/h/w; equal for text positions).

Counterpart of ``repro/configs/qwen2_vl_2b.py`` with the same numbers.
The serving engine, like the JAX one, feeds text tokens only: positions
are t=h=w M-RoPE ids and ``patch_proj`` is built but never applied.
"""

from repro_torch.models.attention import AttnConfig
from repro_torch.models.model import ModelConfig
from repro_torch.models.transformer import BlockSpec

N_PATCHES = 256


def _cfg(n_layers, d_model, n_heads, n_kv, d_ff, vocab, head_dim, sections):
    attn = AttnConfig(
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        rope="mrope",
        mrope_sections=sections,
        qkv_bias=True,
    )
    block = BlockSpec(kind="attn", attn=attn, d_ff=d_ff, ffn_kind="swiglu")
    return ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        d_model=d_model,
        vocab=vocab,
        stacks=(((block,), n_layers),),
        tie_embeddings=True,
        vision_stub=True,
        mrope=True,
    )


def config() -> ModelConfig:
    return _cfg(28, 1536, 12, 2, 8960, 151936, head_dim=128, sections=(16, 24, 24))


def smoke_config() -> ModelConfig:
    return _cfg(2, 64, 4, 2, 256, 512, head_dim=16, sections=(4, 2, 2))
