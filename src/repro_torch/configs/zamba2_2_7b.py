"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention blocks,
54L, d=2560, attn 32H (kv=32), shared-block d_ff=10240, vocab=32000,
ssm_state=64 [arXiv:2411.15242].

Counterpart of ``repro/configs/zamba2_2_7b.py`` with the same numbers.
Pattern of 6: five Mamba2 blocks + one *shared* full-attention block (one
base parameter set reused across all 9 invocations, with per-invocation
LoRA deltas).
"""

from repro_torch.models.attention import AttnConfig
from repro_torch.models.model import ModelConfig
from repro_torch.models.ssm import Mamba2Config
from repro_torch.models.transformer import BlockSpec


def _cfg(n_repeats, d_model, n_heads, d_ff, vocab, d_state, head_dim,
         m2_head_dim=64, chunk=128, lora_rank=64):
    m2 = BlockSpec(
        kind="mamba2",
        mamba=Mamba2Config(
            d_model=d_model, d_state=d_state, head_dim=m2_head_dim, chunk=chunk
        ),
    )
    shared = BlockSpec(
        kind="attn",
        attn=AttnConfig(
            d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads, head_dim=head_dim
        ),
        d_ff=d_ff,
        ffn_kind="swiglu",
        shared=True,
        lora_rank=lora_rank,
    )
    pattern = (m2, m2, m2, m2, m2, shared)
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        d_model=d_model,
        vocab=vocab,
        stacks=((pattern, n_repeats),),
        subquadratic=True,  # Mamba2 backbone; attn KV is 1/6 of layers
    )


def config() -> ModelConfig:
    return _cfg(9, 2560, 32, 10240, 32000, d_state=64, head_dim=80)  # 54 blocks


def smoke_config() -> ModelConfig:
    return _cfg(1, 64, 4, 192, 256, d_state=16, head_dim=16,
                m2_head_dim=16, chunk=8, lora_rank=8)
