"""Architecture registry of the port: ``get_config(name)`` / ``--arch <id>``.

Counterpart of ``repro/configs/__init__.py``.  Each module exports
``config()`` (the published numbers) and ``smoke_config()`` (a reduced
variant of the same family for CPU tests).  Only ``tinyllama-1.1b`` is
ported so far; the other architectures are ROADMAP Queue 1 item "other
model families".
"""

from __future__ import annotations

import importlib
from typing import Dict, List

ALIASES: Dict[str, str] = {
    "tinyllama-1.1b": "tinyllama_1_1b",
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
