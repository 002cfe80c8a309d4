"""End-to-end training driver: a ~100M-param LM for a few hundred steps
(counterpart of ``examples/train_e2e.py``).

Exercises the full substrate — the block stack, data pipeline, AdamW,
checkpointing with restart, NaN containment, straggler watchdog — on the
synthetic corpus, through the port's ``train_loop``.  Loss decreases
from ~ln(V) as the model learns the corpus' bigram structure.

  PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 300
  PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 3 --device cpu
  # kill it mid-run and re-run: it resumes from the newest checkpoint.

``--layers`` cuts the depth (the tests' 2-layer run); every other width
is ``lm_100m``'s.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
from typing import Optional, Sequence

import torch

from repro_torch.data import DataConfig
from repro_torch.launch.train import LoopReport, train_loop
from repro_torch.models import nn
from repro_torch.models.attention import AttnConfig
from repro_torch.models.model import ModelConfig, init_params
from repro_torch.models.transformer import BlockSpec
from repro_torch.optim.adamw import AdamWConfig


def lm_100m() -> ModelConfig:
    """~100M params: 10L, d=640, GQA 10/2 heads, SwiGLU ff=1792."""
    attn = AttnConfig(d_model=640, n_heads=10, n_kv_heads=2, head_dim=64)
    block = BlockSpec(kind="attn", attn=attn, d_ff=1792, ffn_kind="swiglu")
    return ModelConfig(
        name="lm-100m", family="dense", d_model=640, vocab=32000,
        stacks=(((block,), 10),),
    )


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut lm-100m to this many layers")
    ap.add_argument("--ckpt-dir", default="build/train_e2e_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> LoopReport:
    args = parse_args(argv)
    cfg = lm_100m()
    if args.layers is not None:
        (pat, _), = cfg.stacks
        cfg = dataclasses.replace(cfg, stacks=((pat, args.layers),))

    n_params = nn.count_params(init_params(cfg, torch.Generator(), device="meta"))
    print(f"model: {cfg.name}  params: {n_params/1e6:.1f}M")

    report = train_loop(
        cfg,
        DataConfig(seq_len=args.seq_len, global_batch=args.batch),
        AdamWConfig(lr=6e-4),
        steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        accum=args.accum,
        log_every=10,
        device=args.device,
    )
    # the first step of a launch includes its warm-up; the median does not
    ms = statistics.median(report.step_seconds) * 1e3 if report.step_seconds else 0.0
    print(
        f"\ndone. steps={report.steps_run} resumed_from={report.resumed_from} "
        f"loss {report.losses[0]:.3f} → {report.losses[-1]:.3f} "
        f"(stragglers={report.stragglers}, skipped={report.skipped}) "
        f"{ms:.1f} ms/step"
    )
    assert report.losses[-1] < report.losses[0], "loss must decrease"
    return report


if __name__ == "__main__":
    main()
