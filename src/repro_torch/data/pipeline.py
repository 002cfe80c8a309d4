"""Data pipeline: sharded token streams for every arch family (a copy of
``repro/data/pipeline.py``; numpy only, so its batches equal the JAX
package's bit for bit).

Sources:

* ``synthetic`` — deterministic zipf-unigram token stream with local
  n-gram structure (so losses actually go down during the e2e example);
  seeded per (epoch, dp_rank, step) → fully reshardable/elastic: a
  restart with a different data-parallel size replays without overlap.
* ``memmap`` — file-backed corpus of uint32 tokens (np.memmap), windowed
  with a shuffled index — the production path.

Per-family batch shaping (matches ``input_specs`` in the dry-run):
audio (musicgen) gets (B, S, K) codebook tokens; vlm (qwen2-vl) gets
patch-embedding stubs + M-RoPE positions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.model import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    dp_rank: int = 0
    dp_size: int = 1
    seed: int = 0
    source: str = "synthetic"  # synthetic | memmap
    path: Optional[str] = None
    n_patches: int = 256  # vlm stub

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.dp_size:
            raise ValueError(f"global_batch {self.global_batch} is not a multiple of "
                             f"dp_size {self.dp_size}")
        return self.global_batch // self.dp_size


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Zipf unigram + Markov-ish repetition for learnable structure."""
    flat = rng.zipf(1.3, size=int(np.prod(shape)))
    toks = (flat % vocab).astype(np.int32)
    # inject bigram structure: with p=0.3, token t+1 = (t*7+1) % vocab
    mask = rng.random(toks.shape) < 0.3
    shifted = (toks * 7 + 1) % vocab
    toks[1:] = np.where(mask[1:], shifted[:-1], toks[1:])
    return toks.reshape(shape)


def synthetic_stream(cfg: DataConfig, model_cfg: ModelConfig) -> Iterator[Dict[str, np.ndarray]]:
    step = 0
    B, S = cfg.local_batch, cfg.seq_len
    while True:
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + cfg.dp_rank
        )
        if model_cfg.n_codebooks > 1:
            toks = _zipf_tokens(rng, (B, S + 1, model_cfg.n_codebooks), model_cfg.vocab)
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        else:
            toks = _zipf_tokens(rng, (B, S + 1), model_cfg.vocab)
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if model_cfg.vision_stub:
            batch["patch_embeds"] = rng.standard_normal(
                (B, cfg.n_patches, model_cfg.d_model), dtype=np.float32
            ) * 0.02
        step += 1
        yield batch


def memmap_stream(cfg: DataConfig, model_cfg: ModelConfig) -> Iterator[Dict[str, np.ndarray]]:
    if cfg.path is None:
        raise ValueError("memmap source needs a path")
    data = np.memmap(cfg.path, dtype=np.uint32, mode="r")
    n_windows = (len(data) - 1) // cfg.seq_len
    rng = np.random.default_rng(cfg.seed)
    order = rng.permutation(n_windows)
    B, S = cfg.local_batch, cfg.seq_len
    i = cfg.dp_rank  # rank-strided shards
    while True:
        toks = np.empty((B, S + 1), np.int32)
        for b in range(B):
            w = order[i % n_windows]
            i += cfg.dp_size
            start = w * S
            toks[b] = data[start : start + S + 1]
        yield {"tokens": toks[:, :-1] % model_cfg.vocab,
               "labels": toks[:, 1:] % model_cfg.vocab}


def make_batches(cfg: DataConfig, model_cfg: ModelConfig) -> Iterator[Dict[str, np.ndarray]]:
    if cfg.source == "synthetic":
        return synthetic_stream(cfg, model_cfg)
    if cfg.source == "memmap":
        return memmap_stream(cfg, model_cfg)
    raise ValueError(cfg.source)
