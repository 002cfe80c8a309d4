"""gemma3-4b — dense, 34L, d=2560, 8H (GQA kv=4), head_dim=256,
d_ff=10240, vocab=262144; 5:1 local(window 1024):global pattern, 128k
context (local layers rope base 10k, global 1M) [hf:google/gemma-3].

34 layers = 5 repeats of (5 local + 1 global) + a 4-local tail — exact
layer count via two sequential stacks.  Sliding-window layers use rolling
KV caches, which is what makes the ``long_500k`` decode shape feasible
(only the 5 global layers keep full-range KV): this arch runs long_500k.

Counterpart of ``repro/configs/gemma3_4b.py`` with the same numbers.  The
port's serving engine, like the JAX one, pages every layer's KV and
applies the window as a mask in ``paged_attention`` and
``flash_attention``.
"""

from repro_torch.models.attention import AttnConfig
from repro_torch.models.model import ModelConfig
from repro_torch.models.transformer import BlockSpec

WINDOW = 1024


def _cfg(n_pattern_repeats, tail_local, d_model, n_heads, n_kv, d_ff, vocab,
         head_dim, window):
    local_attn = AttnConfig(
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv, head_dim=head_dim,
        window=window, rope_base=10000.0,
    )
    global_attn = AttnConfig(
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv, head_dim=head_dim,
        rope_base=1000000.0,
    )
    L = BlockSpec(kind="attn", attn=local_attn, d_ff=d_ff, ffn_kind="geglu")
    G = BlockSpec(kind="attn", attn=global_attn, d_ff=d_ff, ffn_kind="geglu")
    stacks = [((L, L, L, L, L, G), n_pattern_repeats)]
    if tail_local:
        stacks.append(((L,) * tail_local, 1))
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        d_model=d_model,
        vocab=vocab,
        stacks=tuple(stacks),
        tie_embeddings=True,
        subquadratic=True,  # 5/6 of layers are sliding-window
    )


def config() -> ModelConfig:
    return _cfg(5, 4, 2560, 8, 4, 10240, 262144, head_dim=256, window=WINDOW)


def smoke_config() -> ModelConfig:
    return _cfg(1, 1, 64, 4, 2, 256, 512, head_dim=16, window=8)
