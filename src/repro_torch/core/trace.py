"""Synthetic workload traces calibrated to the paper's characterization (§3).

Each generator yields per-step events — allocations, accesses, frees —
shaped to reproduce the published observations for the four production
workload families:

* **Web**  (§3.4, Fig. 9a): file-I/O warm-up loads binaries/bytecode into
  file cache, then anon usage grows and stays hot; ~80% of pages
  re-accessed within 10 minutes (Fig. 11); anons much hotter than files
  (35-60% vs 3-14% hot within 2 min, Fig. 8).
* **Cache** (Fig. 9b-c): tmpfs-backed lookups — files dominate residency
  (70-82%); anons are request-scoped, short-lived and hot (40% hot/2min
  vs 25% for files).
* **Data Warehouse** (Fig. 9d): anon-heavy (85%), files are cold
  write-back buffers; anons mostly *newly allocated* rather than re-used
  (only ~20% re-accessed in 10 min) — high allocation churn.
* **Ads**: compute-heavy, in-memory data + ML; anon-hot like Web.

A trace step models one characterization interval tick (paper: minutes;
here: one engine step).  Accesses use a Zipf-over-hot-set draw so a stable
fraction of pages is hot while the tail stays cold, with hot-set drift to
model (de)allocation churn (paper §3, observation 4).

A copy of ``repro.core.trace`` with the same behaviour; the port keeps its own
so that it imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.types import PageType


@dataclasses.dataclass
class TraceStep:
    """Events for one step."""

    # pages to allocate this step: list of (trace-local index, page_type)
    allocs: List[Tuple[int, PageType]]
    # logical *trace-local* indices of pages to access this step
    accesses: List[int]
    # trace-local indices of pages freed this step
    frees: List[int]


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Knobs for the synthetic generator."""

    name: str
    total_pages: int
    anon_fraction: float  # residency share of anon pages
    hot_fraction_anon: float  # fraction of anons in the hot set
    hot_fraction_file: float
    accesses_per_step: int
    zipf_a: float = 1.2  # skew within the hot set
    warmup_file_burst: float = 0.0  # fraction allocated as FILE up-front
    churn_rate: float = 0.0  # fraction of anon pages replaced per step
    short_lived_lifetime: int = 8  # steps a churned page lives
    hot_drift: float = 0.02  # fraction of hot set resampled per step
    cold_tail_rate: float = 0.05  # fraction of accesses to cold pages


WORKLOADS: Dict[str, WorkloadSpec] = {
    # Numbers keyed to §3.2-§3.6 (fractions of hot memory per type etc.).
    "web": WorkloadSpec(
        name="web", total_pages=4096, anon_fraction=0.6,
        hot_fraction_anon=0.5, hot_fraction_file=0.08,
        accesses_per_step=2048, warmup_file_burst=0.5,
        churn_rate=0.01, hot_drift=0.02, cold_tail_rate=0.08,
    ),
    "cache1": WorkloadSpec(
        name="cache1", total_pages=4096, anon_fraction=0.25,
        hot_fraction_anon=0.40, hot_fraction_file=0.25, zipf_a=1.4,
        accesses_per_step=2048, warmup_file_burst=0.75,
        churn_rate=0.002, hot_drift=0.01, cold_tail_rate=0.10,
    ),
    "cache2": WorkloadSpec(
        name="cache2", total_pages=4096, anon_fraction=0.3,
        hot_fraction_anon=0.43, hot_fraction_file=0.30, zipf_a=1.4,
        accesses_per_step=2048, warmup_file_burst=0.7,
        churn_rate=0.004, hot_drift=0.015, cold_tail_rate=0.12,
    ),
    "data_warehouse": WorkloadSpec(
        name="data_warehouse", total_pages=4096, anon_fraction=0.85,
        hot_fraction_anon=0.33, hot_fraction_file=0.02,
        accesses_per_step=2048, warmup_file_burst=0.1,
        churn_rate=0.03, hot_drift=0.05, cold_tail_rate=0.05,
        short_lived_lifetime=4,
    ),
    "ads": WorkloadSpec(
        name="ads", total_pages=4096, anon_fraction=0.7,
        hot_fraction_anon=0.45, hot_fraction_file=0.05,
        accesses_per_step=2048, warmup_file_burst=0.15,
        churn_rate=0.01, hot_drift=0.02, cold_tail_rate=0.06,
    ),
}


class TraceGenerator:
    """Streams :class:`TraceStep`s for a workload spec."""

    def __init__(self, spec: WorkloadSpec, seed: int = 0, total_pages: Optional[int] = None):
        self.spec = spec if total_pages is None else dataclasses.replace(
            spec, total_pages=total_pages
        )
        self.rng = np.random.default_rng(seed)
        self._next_idx = 0
        self._live: List[int] = []  # trace-local page indices
        self._type: Dict[int, PageType] = {}
        self._hot: List[int] = []
        self._expiry: Dict[int, int] = {}  # idx -> step to free
        self._step = 0

    # -------------------------------------------------------------- #
    def _new_pages(self, n: int, ptype: PageType, lifetime: int = -1) -> List[Tuple[int, PageType]]:
        out = []
        for _ in range(n):
            idx = self._next_idx
            self._next_idx += 1
            self._live.append(idx)
            self._type[idx] = ptype
            if lifetime > 0:
                self._expiry[idx] = self._step + lifetime
            out.append((idx, ptype))
        return out

    def _rebuild_hot(self) -> None:
        spec = self.spec
        anons = [i for i in self._live if self._type[i] == PageType.ANON]
        files = [i for i in self._live if self._type[i] == PageType.FILE]
        n_ha = int(len(anons) * spec.hot_fraction_anon)
        n_hf = int(len(files) * spec.hot_fraction_file)
        hot = []
        if n_ha and anons:
            hot += list(self.rng.choice(anons, size=min(n_ha, len(anons)), replace=False))
        if n_hf and files:
            hot += list(self.rng.choice(files, size=min(n_hf, len(files)), replace=False))
        self._hot = hot or list(self._live[: max(1, len(self._live) // 4)])

    def _drift_hot(self) -> None:
        """Resample a fraction of the hot set (hotness churn, §3 obs. 4)."""
        spec = self.spec
        n_swap = max(0, int(len(self._hot) * spec.hot_drift))
        if n_swap == 0 or not self._live:
            return
        cold = list(set(self._live) - set(self._hot))
        if not cold:
            return
        self.rng.shuffle(self._hot)
        newly_hot = self.rng.choice(cold, size=min(n_swap, len(cold)), replace=False)
        self._hot = self._hot[n_swap:] + list(newly_hot)

    def _zipf_pick(self, pool: Sequence[int], n: int) -> np.ndarray:
        """Zipf-skewed draw over an ordered pool."""
        if len(pool) == 0 or n == 0:
            return np.empty(0, dtype=np.int64)
        ranks = self.rng.zipf(self.spec.zipf_a, size=n)
        ranks = np.minimum(ranks, len(pool)) - 1
        pool_arr = np.asarray(pool)
        return pool_arr[ranks]

    # -------------------------------------------------------------- #
    def __iter__(self) -> Iterator[TraceStep]:
        return self

    def __next__(self) -> TraceStep:
        spec = self.spec
        allocs: List[Tuple[int, PageType]] = []

        if self._step == 0:
            # Warm-up: file burst (Web: binary/bytecode load; Cache: tmpfs)
            n_file = int(spec.total_pages * spec.warmup_file_burst)
            n_anon0 = int(spec.total_pages * 0.25 * spec.anon_fraction)
            allocs += self._new_pages(n_file, PageType.FILE)
            allocs += self._new_pages(n_anon0, PageType.ANON)
            self._rebuild_hot()
        else:
            # Growth toward the target residency mix.
            target_anon = int(spec.total_pages * spec.anon_fraction)
            target_file = int(spec.total_pages * (1 - spec.anon_fraction))
            n_anon = sum(1 for i in self._live if self._type[i] == PageType.ANON)
            n_file = sum(1 for i in self._live if self._type[i] == PageType.FILE)
            grow_a = min(max(0, target_anon - n_anon), max(8, spec.total_pages // 64))
            grow_f = min(max(0, target_file - n_file), max(4, spec.total_pages // 128))
            if grow_a:
                allocs += self._new_pages(grow_a, PageType.ANON)
            if grow_f:
                allocs += self._new_pages(grow_f, PageType.FILE)
            # Churn: short-lived hot request pages (§5.2: bursts are hot
            # and short-lived).
            n_churn = int(len(self._live) * spec.churn_rate)
            if n_churn:
                allocs += self._new_pages(
                    n_churn, PageType.ANON, lifetime=spec.short_lived_lifetime
                )
            self._drift_hot()

        # Frees: expired short-lived pages.
        frees = [i for i, exp in self._expiry.items() if exp <= self._step]
        for i in frees:
            del self._expiry[i]
            self._live.remove(i)
            self._hot = [h for h in self._hot if h != i]
            # keep _type for late access protection; engine frees its page

        # Accesses: mostly hot set (zipf), small cold tail; fresh churn
        # pages are always touched (they are the request working set).
        n_cold = int(spec.accesses_per_step * spec.cold_tail_rate)
        n_hot = spec.accesses_per_step - n_cold
        acc = list(self._zipf_pick(self._hot, n_hot))
        cold_pool = list(set(self._live) - set(self._hot))
        if cold_pool and n_cold:
            acc += list(self.rng.choice(cold_pool, size=n_cold, replace=True))
        fresh = [i for i in self._live if i in self._expiry]
        acc += fresh

        self._step += 1
        return TraceStep(allocs=allocs, accesses=[int(a) for a in acc], frees=frees)


class MultiTenantTrace:
    """Interleave N per-tenant workloads into one trace (co-running apps).

    The paper's production hosts co-run applications whose placement
    traffic contends for the same fast tier (§6.2); Equilibria-style
    multi-tenant evaluation is where tiering policies differentiate.
    Each tenant runs its own :class:`TraceGenerator` (independent seed);
    per-step events are merged with a collision-free index encoding

        global_idx = local_idx * n_tenants + tenant_id

    so tenant attribution is recoverable from any index without a lookup
    table: :meth:`tenant_of` / :meth:`tenant_of_array`.  The simulator
    uses that to attribute vmstat-style counters (fast/slow accesses,
    allocations, refaults) to each tenant.
    """

    def __init__(
        self,
        specs: Sequence[WorkloadSpec],
        seed: int = 0,
        total_pages_each: Optional[int] = None,
    ) -> None:
        if not specs:
            raise ValueError("MultiTenantTrace needs at least one tenant")
        self.specs = list(specs)
        self.n_tenants = len(self.specs)
        self.tenant_names = [s.name for s in self.specs]
        self.tenants = [
            TraceGenerator(spec, seed=seed + t, total_pages=total_pages_each)
            for t, spec in enumerate(self.specs)
        ]
        # A tenant whose underlying trace exhausts (finite replays) stops
        # contributing events; the mix ends only when *all* tenants have.
        self._exhausted = [False] * self.n_tenants

    # -------------------------------------------------------------- #
    def tenant_of(self, gidx: int) -> int:
        return gidx % self.n_tenants

    def tenant_of_array(self, gidx: np.ndarray) -> np.ndarray:
        return gidx % self.n_tenants

    def _g(self, local_idx: int, tenant: int) -> int:
        return local_idx * self.n_tenants + tenant

    # -------------------------------------------------------------- #
    def __iter__(self) -> Iterator[TraceStep]:
        return self

    def __next__(self) -> TraceStep:
        allocs: List[Tuple[int, PageType]] = []
        accesses: List[int] = []
        frees: List[int] = []
        alive = False
        for t, gen in enumerate(self.tenants):
            if self._exhausted[t]:
                continue
            try:
                step = next(gen)
            except StopIteration:
                self._exhausted[t] = True
                continue
            alive = True
            allocs += [(self._g(i, t), pt) for i, pt in step.allocs]
            accesses += [self._g(i, t) for i in step.accesses]
            frees += [self._g(i, t) for i in step.frees]
        if not alive:
            raise StopIteration
        return TraceStep(allocs=allocs, accesses=accesses, frees=frees)


class ReplayTrace:
    """Replay pre-generated steps (fair engine benchmarking).

    Generating a fleet-scale trace is itself O(pages) Python work; the
    engine benchmarks pre-generate the step list once and replay it to
    every engine/policy so the measured time is pool+policy mechanism
    only.  Tenant attribution is forwarded from the source trace.
    """

    def __init__(self, steps: Sequence[TraceStep], source=None) -> None:
        self._steps = list(steps)
        self._pos = 0
        self.n_tenants = getattr(source, "n_tenants", 1)
        self.tenant_names = getattr(source, "tenant_names", None)
        if source is not None and hasattr(source, "tenant_of"):
            self.tenant_of = source.tenant_of
            self.tenant_of_array = source.tenant_of_array

    def __len__(self) -> int:
        return len(self._steps)

    def reset(self) -> "ReplayTrace":
        """Rewind to the first step (replay the recording again)."""
        self._pos = 0
        return self

    def __iter__(self) -> "ReplayTrace":
        return self

    def __next__(self) -> TraceStep:
        if self._pos >= len(self._steps):
            raise StopIteration
        step = self._steps[self._pos]
        self._pos += 1
        return step


def record_trace(trace, steps: int) -> ReplayTrace:
    """Materialize ``steps`` events from ``trace`` into a ReplayTrace."""
    return ReplayTrace([next(trace) for _ in range(steps)], source=trace)


def workload_total_pages(name: str) -> int:
    """Default page count of a workload name, summing ``a+b`` mixes."""
    return sum(WORKLOADS[part].total_pages for part in name.split("+"))


def make_trace(name: str, seed: int = 0, total_pages: Optional[int] = None):
    """Build a trace for ``name``.

    ``name`` is either one workload ("web") or a ``+``-joined tenant mix
    ("web+cache1+ads") producing a :class:`MultiTenantTrace`.  For a
    mix, ``total_pages`` is the combined footprint, split evenly across
    tenants.
    """
    if "+" in name:
        parts = name.split("+")
        for part in parts:
            if part not in WORKLOADS:
                raise ValueError(
                    f"unknown workload {part!r}; choose from {sorted(WORKLOADS)}"
                )
        per_tenant = total_pages // len(parts) if total_pages else None
        return MultiTenantTrace(
            [WORKLOADS[p] for p in parts], seed=seed,
            total_pages_each=per_tenant,
        )
    if name not in WORKLOADS:
        raise ValueError(f"unknown workload {name!r}; choose from {sorted(WORKLOADS)}")
    return TraceGenerator(WORKLOADS[name], seed=seed, total_pages=total_pages)
