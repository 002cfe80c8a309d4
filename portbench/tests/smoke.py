"""A copy of the benchmark's data at CPU size: smoke configurations of the
same archs and workloads cut to a few short lanes, for the tests."""

import json
import shutil
from pathlib import Path

from portbench.harness.traffic import max_pages

ROOT = Path(__file__).resolve().parents[2]
SMOKE = {"phi3-medium-14b": dict(hidden_size=80, num_attention_heads=4, num_key_value_heads=2,
                                 head_dim=20, intermediate_size=256),
         "phi3.5-moe-8l": dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                               head_dim=16, intermediate_size=128, num_local_experts=4)}


def make_root(dst: Path, prompt_len=(20, 60), output_len=(10, 40), widest_gap=1e-4) -> Path:
    """``dst`` holding ``BENCHMARK.json`` and ``portbench/`` with every
    configuration at its arch's smoke size (2 layers, vocab 256) and every
    workload at 4 lanes; returns ``dst``."""
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for name, sizes in SMOKE.items():
        p = dst / "portbench" / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c.update(preset="smoke", vocab_size=256, num_hidden_layers=2, **sizes)
        p.write_text(json.dumps(c))
    for p in (dst / "portbench" / "workloads").glob("*.json"):
        w = json.loads(p.read_text())
        w.update(lanes=4, prompt_len=list(prompt_len), output_len=list(output_len),
                 warmup_steps=2, trace_seconds=0.5, trace_admits=1)
        if w["tiers"] == "tiered":  # a fifth of every lane at its longest
            w["fast_frames"] = round(0.2 * 4 * max_pages(w, w["page_size"]))
        w["check"].update(sample=3, min_judged=10, widest_gap=widest_gap)
        if w["loop"] == "open":
            w["arrivals"]["mean_rate"] = 6.0
        p.write_text(json.dumps(w))
    return dst
