"""Fault-tolerant checkpointing: atomic, async, resumable (counterpart of
``repro/checkpoint/checkpoint.py``).

* **Atomic**: a step is written under ``.tmp-<step>`` and renamed to
  ``step_<n>`` only after the shard and the fsync'd manifest are
  written, so a killed writer never corrupts the newest checkpoint.
* **Async**: ``save`` copies every leaf to host memory (a real copy, also
  of a CPU tensor, so the next step's in-place update cannot race the
  write) and writes it from a background thread; at most one save is
  outstanding, and its error is raised by the next ``wait``.
* **Resumable**: ``restore_latest`` picks the newest complete manifest,
  rejects a tree of another structure, and puts each leaf on the device
  of the matching leaf of ``like`` (pinned again if that one is pinned).
* Keep-last-k pruning bounds disk.

Storage is one ``.npz`` (leaves in JAX's flatten order, bfloat16 stored
as its 16-bit pattern) plus a JSON manifest.  The JAX treedef is replaced
by the port's structure signature (``nn.tree_signature``: nested keys,
list lengths, NamedTuple fields, Nones); a JAX checkpoint is not read.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import nn

_AS_BITS = {torch.bfloat16: torch.int16}  # numpy has no such type


def _snapshot(tree: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    flat, dtypes = {}, {}
    for i, x in enumerate(nn.tree_leaves(tree)):
        host = x.detach().to("cpu", copy=True)
        name = f"leaf_{i:05d}"
        dtypes[name] = str(host.dtype).removeprefix("torch.")
        flat[name] = host.view(_AS_BITS.get(host.dtype, host.dtype)).numpy()
    return flat, dtypes


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---------------------------------------------------------------- #
    def save(self, step: int, tree: Any, blocking: bool = False,
             extra: Optional[Dict] = None) -> None:
        """Snapshot now, write in the background (or now, ``blocking``)."""
        self.wait()  # one outstanding save at a time
        flat, dtypes = _snapshot(tree)
        manifest = {
            "step": int(step),
            "time": time.time(),
            "treedef": nn.tree_signature(tree),
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in flat.items()},
            "extra": extra or {},
        }

        def _write():
            try:
                tmp = os.path.join(self.dir, f".tmp-{step}")
                final = os.path.join(self.dir, f"step_{step:010d}")
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, "shard_host0.npz"), **flat)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._prune()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if blocking:
            _write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint save failed: {err!r}") from err

    # ---------------------------------------------------------------- #
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def restore(self, step: int, like: Any) -> Any:
        """Load checkpoint ``step`` as a tree shaped like ``like``; each
        leaf goes to the device of ``like``'s leaf at the same place."""
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if nn.tree_signature(like) != manifest["treedef"]:
            raise ValueError("checkpoint treedef mismatch — architecture changed "
                             "between save and restore")
        leaves = iter(range(len(nn.tree_leaves(like))))
        with np.load(os.path.join(path, "shard_host0.npz")) as data:
            def load(x: torch.Tensor) -> torch.Tensor:
                name = f"leaf_{next(leaves):05d}"
                dtype = getattr(torch, manifest["leaves"][name]["dtype"])
                host = torch.from_numpy(data[name]).view(dtype)
                if x.is_pinned():
                    return host.pin_memory()
                return host.to(x.device)

            # tree_map_with_path visits the leaves in the order they were saved
            return nn.tree_map_with_path(lambda _path, x: load(x), like)

    def restore_latest(self, like: Any) -> Tuple[Optional[int], Any]:
        steps = self.steps()
        if not steps:
            return None, like
        step = steps[-1]
        return step, self.restore(step, like)

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

