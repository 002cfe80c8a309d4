"""Shared benchmark harness config.

The canonical experiment geometry mirrors the paper's two setups (§6):

* **2:1** — local:CXL capacity 2:1 (the production config); the fast
  tier comfortably holds the hot set.
* **1:4** — fast tier is 20% of memory (memory-expansion config); only
  part of the hot set fits — the stress test.

All numbers are normalized to the all-fast **ideal** baseline like the
paper's Table 1.  ``slow_cost`` models the CXL latency multiple
(Fig. 2: ~2-3×); ``MEM_STALL_FRAC`` is the memory-bound fraction of app
runtime (calibrated once so that default-Linux's loss lands in the
paper's observed 14-18% band for the 1:4 cache configs — every policy
then uses the SAME constant, so cross-policy deltas are parameter-free).

Counterpart of ``benchmarks/common.py`` (less its ``fmt_row`` and
``timed``, which no suite uses), plus the published peaks of the card
the port runs on, which ``kernel_bench``, ``roofline`` and
``perf_iterations`` divide by.
"""

from __future__ import annotations

from repro_torch.core import TppConfig

SLOW_COST = 3.0
MEM_STALL_FRAC = 0.11
STEPS = 260
MEASURE_FROM = 180
SEED = 1

# sample_rate throttles NUMA-hint faults (kernel: ~256MB/s of sampled
# address space; paper: 50KB/s-1.2MB/s promotion). demote/promote budgets
# model continuous background migration within one interval.
POLICY_CFG = TppConfig(demote_budget=512, promote_budget=256, sample_rate=0.1)

# (fast_frames, slow_frames, total_pages): fast holds ~66% / ~20%.
# Frame totals leave ~10% headroom over the live-page peak (the traces
# carry short-lived churn above total_pages, §5.2's allocation bursts).
GEOM = {
    "2:1": (2176, 1088, 2950),
    "1:4": (544, 2176, 2400),
}

POLICIES = ("linux", "tpp", "numa_balancing", "autotiering")

# NVIDIA H100 SXM at its 700 W power limit, NVIDIA's data sheet (dense
# rates, no sparsity): HBM3 bandwidth, and peak FLOP/s by input type
# (float32 outside the tensor cores, bfloat16 on them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# The link a 256/512-rank production mesh's collectives cross: the mesh
# spans 32-64 hosts of 8 cards, and a collective over the data axes
# leaves the host through one 400 Gb/s NDR InfiniBand NIC per card.  One
# such link per card is assumed (conservative: NVLink inside a host is
# faster, and a ring can use several NICs).
NET_BYTES_PER_S = 50e9
