"""Architecture registry of the port: ``get_config(name)`` / ``--arch <id>``.

Counterpart of ``repro/configs/__init__.py``.  Each module exports
``config()`` (the published numbers) and ``smoke_config()`` (a reduced
variant of the same family for CPU tests).  Ported: the seven
architectures the JAX ``ServingEngine`` pages (GQA or MHA attention):
tinyllama-1.1b, gemma3-4b, phi3-medium-14b, chatglm3-6b, qwen2-vl-2b,
musicgen-medium (dense FFNs) and phi3.5-moe-42b-a6.6b (MoE).  The three
the JAX engine does not serve (deepseek-v2-lite-16b, MLA; zamba2-2.7b and
xlstm-350m, recurrent mixers) belong to ROADMAP Queue 1 item 7's next
slice, "MLA and the SSM mixers", and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

ALIASES: Dict[str, str] = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "gemma3-4b": "gemma3_4b",
    "phi3-medium-14b": "phi3_medium_14b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "musicgen-medium": "musicgen_medium",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
}


def _module(name: str):
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod not in ALIASES.values():
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (have {list(ALIASES)}); "
            "see ROADMAP Queue 1 item 7, 'MLA and the SSM mixers'"
        )
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke_config()


def list_archs() -> List[str]:
    return list(ALIASES.keys())
