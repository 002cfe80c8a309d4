"""MoE expert tiering (DESIGN.md §2): TPP over expert parameter pages.

Counterpart of ``benchmarks/expert_tiering.py`` over the port's
:class:`~repro_torch.serving.expert_tier.ExpertTierManager`: zipf-routed
experts, an HBM bank sized below L×E, policies compared on HBM-hit
fraction and modeled cost — phi3.5-moe (16e top-2) and
deepseek-v2-lite (64e top-6) geometries.  The fast bank lives on
``--device`` (default ``cuda``), the slow bank on the host (pinned on
CUDA).  Prints the JAX benchmark's CSV rows; the counts are equal to
its, the timing column is this machine's.

  PYTHONPATH=src python -m repro_torch.benchmarks.expert_tiering --quick --device cpu
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from repro_torch.core import TppConfig
from repro_torch.serving.expert_tier import ExpertTierConfig, ExpertTierManager

CASES = [
    # (name, layers, experts, top_k, fast_capacity fraction)
    ("phi3.5-moe", 8, 16, 2, 0.4),
    ("deepseek-v2-lite", 8, 64, 6, 0.25),
]
POLICIES = ("linux", "autotiering", "tpp")


def manager(L: int, E: int, frac: float, policy: str, weights: Dict[str, object],
            device="cuda") -> ExpertTierManager:
    """The benchmark's manager: ``int(frac·L·E)`` fast experts,
    ``TppConfig(demote_budget=16, promote_budget=16)``, seed 1."""
    return ExpertTierManager(
        ExpertTierConfig(
            n_layers=L, n_experts=E, fast_capacity=int(frac * L * E),
            policy=policy,
            tpp=TppConfig(demote_budget=16, promote_budget=16),
        ),
        weights, seed=1, device=device,
    )


def drive(mgr: ExpertTierManager, K: int, steps: int) -> None:
    """The benchmark's hit stream: each step, ``K`` zipf(1.5) experts a
    layer from ``default_rng(2)``, each looked up then reported; an
    interval tick every 4 steps."""
    L, E = mgr.cfg.n_layers, mgr.cfg.n_experts
    rr = np.random.default_rng(2)
    for step in range(steps):
        hits = []
        for l in range(L):
            ranks = np.minimum(rr.zipf(1.5, size=K), E) - 1
            hits += [(l, int(r)) for r in ranks]
        for (l, e) in hits:
            mgr.lookup(l, e)
        mgr.step(hits)
        if step % 4 == 0:
            mgr.pool.end_interval()


def run(quick: bool = False, device="cuda") -> List[str]:
    steps = 120 if quick else 300
    out = []
    for name, L, E, K, frac in CASES:
        rng = np.random.default_rng(0)
        weights = {"wi": rng.standard_normal((L, E, 8, 16)).astype(np.float32)}
        for policy in POLICIES:
            mgr = manager(L, E, frac, policy, weights, device=device)
            t0 = time.time()
            drive(mgr, K, steps)
            dt_us = (time.time() - t0) * 1e6 / steps
            out.append(
                f"expert_tier/{name}/{policy},{dt_us:.1f},"
                f"hbm_frac={mgr.fast_fraction():.3f};"
                f"cost={mgr.modeled_cost():.0f};"
                f"promoted={mgr.pool.vmstat.pgpromote_total}"
            )
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="120 steps, not 300")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for line in run(quick=args.quick, device=args.device):
        print(line)
