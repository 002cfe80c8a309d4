"""xlstm-350m — attention-free, 24L, d=1024, 4H, vocab=50304;
sLSTM + mLSTM blocks at 7:1 (pattern of 8: 7 mLSTM + 1 sLSTM)
[arXiv:2405.04517].

Counterpart of ``repro/configs/xlstm_350m.py`` with the same numbers.
No KV cache: decode carries O(1) recurrent state.
"""

from repro_torch.models.model import ModelConfig
from repro_torch.models.ssm import MlstmConfig, SlstmConfig
from repro_torch.models.transformer import BlockSpec


def _cfg(n_repeats, d_model, n_heads, vocab, chunk=256):
    m = BlockSpec(kind="mlstm", mlstm=MlstmConfig(d_model=d_model, n_heads=n_heads, chunk=chunk))
    s = BlockSpec(kind="slstm", slstm=SlstmConfig(d_model=d_model, n_heads=n_heads))
    pattern = (m, m, m, m, m, m, m, s)
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        d_model=d_model,
        vocab=vocab,
        stacks=((pattern, n_repeats),),
        tie_embeddings=True,
        subquadratic=True,
    )


def config() -> ModelConfig:
    return _cfg(3, 1024, 4, 50304)  # 24 layers


def smoke_config() -> ModelConfig:
    return _cfg(1, 64, 4, 256, chunk=8)  # 8 layers
