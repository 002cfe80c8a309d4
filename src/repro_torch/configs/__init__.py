"""Architecture registry of the port: ``get_config(name)`` / ``--arch <id>``.

Counterpart of ``repro/configs/__init__.py``.  Each module exports
``config()`` (the published numbers) and ``smoke_config()`` (a reduced
variant of the same family for CPU tests).  Ported so far:
``tinyllama-1.1b`` (dense) and ``phi3.5-moe-42b-a6.6b`` (MoE); the other
architectures are ROADMAP Queue 1 item "other model families".
"""

from __future__ import annotations

import importlib
from typing import Dict, List

ALIASES: Dict[str, str] = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
}


def _module(name: str):
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod not in ALIASES.values():
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (have {list(ALIASES)}); "
            "see ROADMAP Queue 1 item 'other model families'"
        )
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke_config()


def list_archs() -> List[str]:
    return list(ALIASES.keys())
