"""Serving data-plane benchmark — reference vs batched decode, plus QoS.

Decodes the same request mix through both data planes at several batch
sizes and reports steady-state decode throughput (tokens/sec, prefill
and warm-up excluded); greedy-token parity between the planes is
asserted on every run — a speedup that changes results is a bug, not a
win.

A second section runs the **QoS noisy-neighbor** scenario: one
latency-critical decode stream shares a small fast tier with a churny
batch tenant (sequences constantly finishing and re-admitting).
Tenant-blind TPP lets the churn evict the stream's hot pages; with the
QoS arbiter armed (priority-weighted static shares + per-tenant
promotion token buckets) the stream holds its fast-tier residency.

Counterpart of ``benchmarks/serving_bench.py`` over the port's
:class:`~repro_torch.serving.ServingEngine` on ``--device`` (default
``cuda``; the wall clock of the timed window ends in a synchronise).
The JAX benchmark serves the smoke config; this one serves tinyllama-1.1b
at its published widths with weights seeded 0 on the device, and the
smoke config with ``--smoke``.  With the smoke config and the JAX
weights the tokens and the QoS numbers equal the JAX benchmark's
(``tests/test_torch_benchmarks.py``).  The JSON is written only to the
path ``--out`` names, never to ``BENCH_serving.json``.

  PYTHONPATH=src python -m repro_torch.benchmarks.serving_bench --smoke --quick --device cpu
  python -m repro_torch.benchmarks.serving_bench --quick --out serving.json   # on the card
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import Tier, TppConfig
from repro_torch.qos import QosConfig
from repro_torch.serving import AdmissionError, EngineConfig, ServingEngine

MODEL = "tinyllama-1.1b"
BATCH_SIZES = (2, 4, 8)
PROMPT_LEN = 16
DECODE_STEPS = 24
# enough steps for tiering pressure to kick in: the staged-copy width
# stabilizes before the timed window (steady state)
WARMUP_STEPS = 8


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _engine(cfg, params, plane: str, batch: int, device) -> ServingEngine:
    return ServingEngine(cfg, params, EngineConfig(
        page_size=4, num_fast=48, num_slow=256,
        topk_pages=4, recent_pages=2, max_seqs=max(8, batch),
        data_plane=plane,
        tpp=TppConfig(demote_budget=16, promote_budget=8),
    ), seed=0, device=device)


def _decode_run(cfg, params, plane: str, batch: int, steps: int, device):
    eng = _engine(cfg, params, plane, batch, device)
    rng = np.random.default_rng(0)
    rids = [
        eng.add_request(list(rng.integers(0, cfg.vocab, PROMPT_LEN)),
                        max_new=steps + WARMUP_STEPS)
        for _ in range(batch)
    ]
    eng._grow_summaries(16)  # pre-size summary arrays, as the JAX benchmark does
    tokens = {rid: [] for rid in rids}
    for _ in range(WARMUP_STEPS):
        for rid, tok in eng.step().items():
            tokens[rid].append(tok)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        for rid, tok in eng.step().items():
            tokens[rid].append(tok)
    _sync(device)
    dt = time.perf_counter() - t0
    return dt, tokens


# ---- QoS noisy-neighbor scenario ----------------------------------- #
QOS_STEPS = 48
QOS_CHURN_EVERY = 8  # rotate one noisy sequence every N steps


def _qos_noisy_neighbor(cfg, params, qos, steps: int, device):
    """One latency-critical stream vs a churny batch tenant; returns the
    stream's final fast-tier residency fraction + engine stats.

    The control plane may *shed* a batch re-admission under fast-tier
    pressure (``AdmissionError reason="qos_pressure"``) — that is the
    admission gate working, so sheds are counted and the churn retries
    next rotation.
    """
    eng = ServingEngine(cfg, params, EngineConfig(
        page_size=4, num_fast=24, num_slow=256,
        topk_pages=4, recent_pages=2, max_seqs=8,
        data_plane="batched",
        tpp=TppConfig(demote_budget=16, promote_budget=8),
        qos=qos,
    ), seed=0, device=device)
    rng = np.random.default_rng(0)
    prompt = lambda: list(rng.integers(0, cfg.vocab, PROMPT_LEN))  # noqa: E731
    lc = eng.add_request(prompt(), max_new=10_000,
                         qos_class="latency_critical", tenant=0)
    noisy = [eng.add_request(prompt(), max_new=10_000,
                             qos_class="batch", tenant=1) for _ in range(5)]
    shed = 0
    for step in range(steps):
        eng.step()
        if step % QOS_CHURN_EVERY == QOS_CHURN_EVERY - 1:
            eng.finish(noisy.pop(0))
            try:
                noisy.append(eng.add_request(prompt(), max_new=10_000,
                                             qos_class="batch", tenant=1))
            except AdmissionError as e:
                if e.reason != "qos_pressure":
                    raise
                shed += 1
    seq = eng.seqs[lc]
    n_fast = sum(
        1 for pid in seq.pages if eng.kv.pool.pages[pid].tier == Tier.FAST
    )
    stats = eng.stats()
    stats["batch_sheds"] = shed
    return n_fast / len(seq.pages), stats


def measure(cfg, params, quick: bool = False, device="cuda") -> Dict[str, Any]:
    """Both planes at each batch size and the QoS scenario on ``params``
    (on ``device``) → ``{"lines", "payload", "tokens"}``: the CSV rows,
    the JSON payload, and each plane's tokens by batch size."""
    steps = 8 if quick else DECODE_STEPS
    batches = BATCH_SIZES[:2] if quick else BATCH_SIZES

    lines: List[str] = []
    results, tokens = {}, {}
    for batch in batches:
        row = {}
        toks = {}
        for plane in ("reference", "batched"):
            dt, toks[plane] = _decode_run(cfg, params, plane, batch, steps, device)
            n_tok = batch * steps
            row[plane] = {
                "seconds": round(dt, 3),
                "tokens": n_tok,
                "tokens_per_sec": round(n_tok / dt, 1),
            }
            lines.append(
                f"serving/{plane}_b{batch},{dt * 1e6 / steps:.1f},"
                f"tokens_per_sec={n_tok / dt:.1f}"
            )
        if toks["batched"] != toks["reference"]:
            raise AssertionError(f"data-plane parity broken at batch {batch}")
        tokens[batch] = toks
        speedup = (row["batched"]["tokens_per_sec"]
                   / row["reference"]["tokens_per_sec"])
        row["speedup"] = round(speedup, 2)
        results[str(batch)] = row
        lines.append(f"serving/speedup_b{batch},0.0,x{speedup:.1f}")

    # ---- QoS noisy neighbor: latency-critical vs churny batch ------- #
    qos_steps = 24 if quick else QOS_STEPS
    qos_results = {}
    for label, qos in (
        ("tenant_blind", None),
        ("qos", QosConfig(mode="static", promote_tokens_per_interval=16.0)),
    ):
        residency, stats = _qos_noisy_neighbor(cfg, params, qos, qos_steps, device)
        qos_results[label] = {
            "lc_fast_residency": round(residency, 4),
            "local_fraction": round(stats["local_fraction"], 4),
            "demoted": stats["demoted"],
            "promoted": stats["promoted"],
            "batch_sheds": stats["batch_sheds"],
        }
        lines.append(f"serving/qos_{label},0.0,lc_fast_residency={residency:.3f}")

    payload = {
        "model": cfg.name,
        "device": str(device),
        "prompt_len": PROMPT_LEN,
        "decode_steps": steps,
        "batch_sizes": list(batches),
        "results": results,
        "qos_noisy_neighbor": {
            "steps": qos_steps,
            "churn_every": QOS_CHURN_EVERY,
            **qos_results,
        },
    }
    return {"lines": lines, "payload": payload, "tokens": tokens}


def run(quick: bool = False, smoke: bool = False, device="cuda",
        out: Optional[str] = None) -> List[str]:
    """:func:`measure` on ``MODEL`` (its smoke config with ``smoke``),
    weights seeded 0 on ``device``; writes the JSON to ``out`` when
    given."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.model import init_params

    cfg = get_smoke_config(MODEL) if smoke else get_config(MODEL)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    report = measure(cfg, params, quick=quick, device=device)
    if out is not None:
        with open(out, "w") as f:
            json.dump(report["payload"], f, indent=2)
    return report["lines"]


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="batch 2 and 4, 8 timed steps, 24 QoS steps")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", metavar="PATH", help="write the JSON results here")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda":
        from repro_torch.launch.serve import strict_fp32

        strict_fp32()
    for row_line in run(quick=args.quick, smoke=args.smoke, device=args.device,
                        out=args.out):
        print(row_line)
