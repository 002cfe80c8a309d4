"""Architecture registry of the port: ``get_config(name)`` / ``--arch <id>``.

Counterpart of ``repro/configs/__init__.py``.  Each module exports
``config()`` (the published numbers) and ``smoke_config()`` (a reduced
variant of the same family for CPU tests).  Every architecture of the
JAX package: the seven the JAX ``ServingEngine`` pages (GQA or MHA
attention): tinyllama-1.1b, gemma3-4b, phi3-medium-14b, chatglm3-6b,
qwen2-vl-2b, musicgen-medium (dense FFNs) and phi3.5-moe-42b-a6.6b
(MoE), listed by :func:`served_archs`; and three that both engines
refuse, which train and decode through ``decode_step``:
deepseek-v2-lite-16b (MLA and MoE), zamba2-2.7b (Mamba2 and a shared
attention block with LoRA deltas) and xlstm-350m (mLSTM and sLSTM).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

# the module names, in the order of ``repro/configs/__init__.py``
ARCHS: List[str] = [
    "chatglm3_6b",
    "phi3_medium_14b",
    "gemma3_4b",
    "tinyllama_1_1b",
    "xlstm_350m",
    "musicgen_medium",
    "zamba2_2_7b",
    "phi3_5_moe_42b",
    "deepseek_v2_lite_16b",
    "qwen2_vl_2b",
]

ALIASES: Dict[str, str] = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "gemma3-4b": "gemma3_4b",
    "phi3-medium-14b": "phi3_medium_14b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "musicgen-medium": "musicgen_medium",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "zamba2-2.7b": "zamba2_2_7b",
    "xlstm-350m": "xlstm_350m",
}

SHAPES = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def _module(name: str):
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke_config()


def list_archs() -> List[str]:
    return list(ALIASES.keys())


def served_archs() -> List[str]:
    """The archs the serving engine pages: every block GQA or MHA
    attention (the engine refuses MLA and the recurrent mixers)."""
    return [name for name in ALIASES
            if all(s.kind == "attn" and not s.attn.is_mla
                   for s in get_smoke_config(name).all_specs())]
