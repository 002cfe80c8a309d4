"""Named spans inside the port's serving path, for ``torch.profiler``.

``span(name)`` is ``torch.profiler.record_function(name)`` while the
profiler records, so the span lands in the same trace as the device
operations it launches; otherwise it is one shared no-op context, at the
cost of one check.  ``NAMES`` lists every span the port records:

* ``kv.flush`` — ``TieredKVCache.flush_migrations``' gather and scatter;
* ``engine.score``, ``engine.select``, ``engine.tables``, ``engine.h2d``,
  ``engine.forward``, ``engine.d2h`` — the phases of a batched decode
  step, in order (``ServingEngine._decode_batched``);
* ``policy.step``, ``pool.end_interval`` — placement, in ``step``;
* ``engine.prefill`` around ``engine.prefill.forward`` and
  ``engine.prefill.write`` — one request's prefill;
* ``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine`` — the
  stages of ``models.moe.moe_fwd``.
"""

from __future__ import annotations

import contextlib

import torch

NAMES = (
    "kv.flush",
    "engine.score", "engine.select", "engine.tables", "engine.h2d",
    "engine.forward", "engine.d2h",
    "policy.step", "pool.end_interval",
    "engine.prefill", "engine.prefill.forward", "engine.prefill.write",
    "moe.route", "moe.dispatch", "moe.experts", "moe.combine",
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` span while the profiler records, else a no-op."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
