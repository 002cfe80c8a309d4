"""Static analysis + runtime sanitizers for the tiering stack.

Copies of the JAX package's ``repro.analysis`` tools (DESIGN.md §9),
with the same behaviour:

* :mod:`repro_torch.analysis.repro_lint` — AST static analyzer with
  repo-specific rules (host↔device syncs in jit-reachable code, traced
  control flow, the removed ``pool.qos`` surface, missing tenant
  attribution, …), the same findings as JAX's on the same source, with
  the port's tracers (``torch.compile``,
  ``torch.cuda.make_graphed_callables``, ``with torch.cuda.graph``) as
  roots beside ``jax.jit``.  CLI: ``python -m
  repro_torch.analysis.repro_lint <paths>``; its entry points are
  exported here, imported on first use.
* :mod:`repro_torch.analysis.plan_verify` — hazard verifier for staged
  ``page_gather``/``page_scatter`` migration plans (RAW frame reuse,
  duplicate destinations, trash-frame misuse, out-of-range frames).
* :mod:`repro_torch.analysis.tiersan` — TierSan, the leveled runtime
  invariant sanitizer for both pool engines (conservation laws every
  interval, full LRU/frame/ledger audits on demand) plus a differential
  engine-parity mode.
"""

from repro_torch.analysis.plan_verify import (  # noqa: F401
    CopyOp,
    Hazard,
    PlanHazardError,
    check_plan,
    plan_from_staged,
    verify_plan,
)
from repro_torch.analysis.tiersan import (  # noqa: F401
    TierSan,
    TierSanError,
    check_fleet_conservation,
    diff_engines,
    tiersan_from_env,
)

_LINT = ("Finding", "RULES", "lint_file", "lint_paths", "lint_source")


def __getattr__(name):
    """``repro_lint``'s entry points, imported on first use, so that
    ``python -m repro_torch.analysis.repro_lint`` runs the module once."""
    if name in _LINT:
        from repro_torch.analysis import repro_lint

        return getattr(repro_lint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
