"""Static analysis + runtime sanitizers for the tiering stack.

Copies of the JAX package's ``repro.analysis`` tools (DESIGN.md §9),
with the same behaviour, less ``repro_lint``: most of that static
analyzer's rules check ``jax.jit`` tracing, which the port does not use.

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
