"""MoE expert tiering — TPP over expert parameter "pages".

Counterpart of ``repro/serving/expert_tier.py``.  MoE routing traffic
is zipf-skewed in production, so cold experts are prime slow-tier
candidates.  Mapping:

* page          = one (layer, expert) weight bundle (wi_gate, wi_up, wo)
* access stream = router top-k hits per decode/prefill step
* fast tier     = device expert bank: one device tensor of
  ``(fast_capacity, ...)`` per weight name, in the card's HBM
* slow tier     = host expert bank: one host tensor of ``(L·E, ...)``
  per weight name, in pinned memory when the device is CUDA, reached
  over the host link (the H100's nearest thing to a CXL tier)

The same :class:`PagePool` + policy machinery manages placement: the
router's per-step expert hits are the hint-fault stream; watermarks keep
HBM headroom so *newly hot* experts can promote immediately (the §5.2
decoupling argument, verbatim).  Payload moves are real copies, one
``copy_`` per weight name: host→device on a promotion, device→host on a
demotion.  The pool, the policy, the control plane and every counter
are the JAX manager's, so the same hit stream gives the same counts.

A fast-tier miss (token routed to a host-resident expert) is served by
a host gather — modeled cost ``slow_cost``× the HBM access — and
counted, giving the Table-1-style comparison for expert placement
policies in ``repro_torch/benchmarks/expert_tiering.py``.
:meth:`ExpertTierManager.as_shard_pool` registers the expert pool as a
shard of a ``repro_torch.fleet`` coordinator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import PagePool, PageType, Tier, TppConfig, make_policy


@dataclasses.dataclass(frozen=True)
class ExpertTierConfig:
    n_layers: int
    n_experts: int
    fast_capacity: int  # experts resident in HBM (< n_layers*n_experts)
    policy: str = "tpp"
    tpp: TppConfig = dataclasses.field(default_factory=TppConfig)
    slow_cost: float = 8.0  # host-gather latency multiple vs HBM


def _slow_bank(w, total: int, pinned: bool) -> torch.Tensor:
    """``w`` stacked ``(L, E, ...)`` copied into a fresh host tensor of
    ``(L·E, ...)``, pinned when ``pinned``: migrations rewrite the bank's
    rows, never the caller's weights (as the JAX manager copies)."""
    t = w if isinstance(w, torch.Tensor) else torch.from_numpy(np.asarray(w))
    t = t.reshape((total,) + tuple(t.shape[2:]))
    bank = torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
    bank.copy_(t)
    return bank


class ExpertTierManager:
    """Two-tier expert banks (device and host) + placement policy."""

    def __init__(
        self,
        cfg: ExpertTierConfig,
        expert_weights: Dict[str, object],  # each (L, E, ...) stacked
        seed: int = 0,
        control=None,
        tenant_of_expert=None,
        device="cuda",
    ) -> None:
        """``expert_weights`` maps each weight name to a NumPy array or a
        tensor stacked ``(L, E, ...)``, on any device; the slow bank is
        always a copy of them.  ``device`` holds the fast bank; the slow
        bank stays on the host, pinned when ``device`` is CUDA.
        A CUDA manager on a machine without CUDA raises rather than keep
        a bank on the CPU.

        ``control`` attaches a :class:`~repro_torch.core.control.
        TieringControl` (e.g. a ``TenantAccounting`` or ``QosArbiter``)
        to the expert pool; ``tenant_of_expert(layer, expert) -> int``
        attributes each shared-expert frame to a tenant (default: all
        tenant 0), so expert residency/hotness lands in the same
        per-tenant ledger the KV tiers use (ROADMAP "expert tiering
        under QoS")."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ExpertTierManager(device='cuda') but CUDA is not available; "
                "pass device='cpu' to keep both banks on the host"
            )
        self.cfg = cfg
        L, E = cfg.n_layers, cfg.n_experts
        total = L * E
        self.names = list(expert_weights)
        pinned = self.device.type == "cuda"
        # payload banks: fast bank has fast_capacity slots, slow holds all
        self.slow_bank = {
            k: _slow_bank(v, total, pinned) for k, v in expert_weights.items()
        }
        self.fast_bank = {
            k: torch.zeros((cfg.fast_capacity,) + tuple(v.shape[1:]),
                           dtype=v.dtype, device=self.device)
            for k, v in self.slow_bank.items()
        }
        self.pool = PagePool(
            cfg.fast_capacity, total, config=cfg.tpp, on_migrate=self._do_migrate
        )
        self._control = control
        if control is not None:
            self.pool.control = control
        self._tenant_of_expert = tenant_of_expert or (lambda l, e: 0)
        self.policy = make_policy(cfg.policy, self.pool, seed=seed)
        # page id per (layer, expert) — allocate all as FILE on slow first
        # (experts are bulky long-lived parameters), then let traffic
        # promote the hot ones: the §5.4 type-aware starting point.
        self.pid_of: Dict[Tuple[int, int], int] = {}
        for le in range(total):
            l, e = le // E, le % E
            page = self.pool.allocate(
                PageType.FILE, prefer=Tier.SLOW,
                tenant=self._tenant_of_expert(l, e) if control is not None
                else -1,
            )
            self.pid_of[(l, e)] = page.pid
            # slow frame must equal its bank row: allocation order gives
            # frame == le because the slow free-list pops ascending
            assert page.tier == Tier.SLOW and page.frame == le, (page.tier, page.frame, le)
        self.hbm_hits = 0
        self.host_hits = 0
        self.steps = 0

    # ---------------------------------------------------------------- #
    def _do_migrate(self, pid, src, src_frame, dst, dst_frame) -> None:
        for k in self.names:
            if src == Tier.FAST:  # demotion: device -> host
                self.slow_bank[k][dst_frame].copy_(self.fast_bank[k][src_frame])
            else:  # promotion: host -> device
                self.fast_bank[k][dst_frame].copy_(self.slow_bank[k][src_frame])

    def lookup(self, layer: int, expert: int) -> Tuple[Dict[str, torch.Tensor], Tier]:
        """Fetch an expert's weights (device rows of the fast bank, or
        host rows of the slow bank); counts tier traffic."""
        pid = self.pid_of[(layer, expert)]
        page = self.pool.pages[pid]
        bank = self.fast_bank if page.tier == Tier.FAST else self.slow_bank
        if page.tier == Tier.FAST:
            self.hbm_hits += 1
        else:
            self.host_hits += 1
        return {k: bank[k][page.frame] for k in self.names}, page.tier

    def step(self, expert_hits: Sequence[Tuple[int, int]]) -> None:
        """Report one step of router traffic [(layer, expert), ...]."""
        slow_hits: List[int] = []
        fast_hits: List[int] = []
        for (l, e) in expert_hits:
            pid = self.pid_of[(l, e)]
            tier = self.pool.touch(pid)
            (slow_hits if tier == Tier.SLOW else fast_hits).append(pid)
        # Uniform PlacementPolicy protocol — no per-policy special cases.
        self.policy.step(slow_hits, fast_hits)
        self.steps += 1
        if self._control is not None:
            # per-tenant hotness telemetry; interval ticks stay with the
            # caller (``mgr.pool.end_interval()``), same convention as
            # the simulator and benchmarks
            self._control.note_hits(
                np.fromiter(fast_hits, np.int64, count=len(fast_hits)),
                np.fromiter(slow_hits, np.int64, count=len(slow_hits)),
            )

    # ---------------------------------------------------------------- #
    def modeled_cost(self) -> float:
        return self.hbm_hits + self.cfg.slow_cost * self.host_hits

    def fast_fraction(self) -> float:
        t = self.hbm_hits + self.host_hits
        return self.hbm_hits / t if t else 1.0

    def placement(self) -> np.ndarray:
        """(L, E) bool — True where expert is HBM-resident."""
        L, E = self.cfg.n_layers, self.cfg.n_experts
        out = np.zeros((L, E), bool)
        for (l, e), pid in self.pid_of.items():
            out[l, e] = self.pool.pages[pid].tier == Tier.FAST
        return out

    def as_shard_pool(self, host: int = 0, name: str = "experts", slo=None):
        """Register the expert pool as a fleet shard (see
        :meth:`repro_torch.serving.engine.ServingEngine.as_shard_pool`);
        the shard's modeled slow cost is the expert bank's host-gather
        multiple.  Import is lazy so expert tiering stays usable
        without the fleet package."""
        from repro_torch.fleet.shard import ShardPool

        return ShardPool(
            host=host, name=name, pool=self.pool,
            control=self._control, slo=slo,
            slow_cost=self.cfg.slow_cost,
        )
