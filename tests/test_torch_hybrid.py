"""zamba2's shared (base + LoRA) attention blocks in the serving engine,
and the recurrent archs' bfloat16 trees, against the JAX package.

* A test-only config with tinyllama-1.1b's smoke widths and the pattern
  (attn, shared attn) × 2 repeats, LoRA rank 8: the port's engine over
  the lifecycle of ``tests/test_serving_parity.py`` equals the JAX
  engine's on both data planes, with the LoRA ``qb``/``ob`` seeded
  nonzero (at init they are zero and the delta vanishes).  Every field
  must be equal, not close.
* zamba2-2.7b's and xlstm-350m's smoke trees in bfloat16, built by JAX's
  ``init_params(dtype=bfloat16)`` (mLSTM gates, ``dt_bias``, ``A_log``,
  ``D`` and the sLSTM biases stay float32, so the products mix dtypes)
  or by ``cast_tree`` (every leaf bfloat16), labels the tokens: the
  port's tree keeps JAX's dtypes leaf for leaf, and its loss equals
  JAX's to bfloat16's precision, within its unit roundoff 2^-8 of JAX's
  loss.  Not within the 1e-4 that ``test_torch_train_models.py`` holds
  the MoE router's bfloat16 loss to: the two frameworks round bfloat16
  intermediates in other places (torch rounds ``silu``, ``sigmoid`` and
  ``softplus`` once, XLA's differ in 16-39% of bfloat16 inputs), and
  these stacks of exponential gates carry that to the loss: reached
  4.6e-4 to 2.6e-3 here, where JAX's own jitted and op-by-op losses are
  up to 7.1e-4 apart and tinyllama-1.1b's is 3.4e-4 from the port's.

JAX weights reach the port through ``params_from_jax`` (bfloat16 leaves
bit for bit); the CPU.  zamba2's training state round-trips through a
checkpoint with its None blocks.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import TppConfig as JaxTppConfig  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from test_serving_parity import lifecycle_trace as jax_lifecycle_trace  # noqa: E402
from test_torch_models import _flatten, perturb_lora  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import TppConfig  # noqa: E402
from repro_torch.launch.serve import lifecycle_trace  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402

# tests/test_serving_parity.py:37-40
BASE = dict(page_size=4, num_fast=10, num_slow=64, recent_pages=1)
FIELDS = ("tokens", "stats", "finished_out", "tiers", "types", "vmstat")


def shared_config(get):
    """tinyllama-1.1b's smoke widths, pattern (attn, shared attn) × 2."""
    cfg = get("tinyllama-1.1b")
    blk = cfg.stacks[0][0][0]
    shared = dataclasses.replace(blk, shared=True, lora_rank=8)
    return dataclasses.replace(cfg, name="tinyllama-shared-smoke",
                               stacks=(((blk, shared), 2),))


@functools.lru_cache(maxsize=None)
def shared_models():
    jcfg = shared_config(jax_smoke_config)
    jp = perturb_lora(jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    tp = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, shared_config(get_smoke_config), tp


def engine_config(plane, cls=EngineConfig, tpp=TppConfig):
    return cls(data_plane=plane, topk_pages=2,
               tpp=tpp(demote_budget=16, promote_budget=8), **BASE)


@pytest.mark.parametrize("plane", ["batched", "reference"])
def test_shared_block_lifecycle_matches_jax_engine(plane):
    jcfg, jp, tcfg, tp = shared_models()
    assert tp["stacks"][0]["blocks"][1] is None and tp["stacks"][0]["shared"][0] is None
    want = jax_lifecycle_trace(jcfg, jp, engine_config(plane, JaxEngineConfig,
                                                       JaxTppConfig))
    got = lifecycle_trace(ServingEngine(tcfg, tp, engine_config(plane), seed=0,
                                        device="cpu"), tcfg.vocab)
    assert want["stats"][-1]["demoted"] > 0, "the trace must exercise tiering"
    for field in FIELDS:
        assert got[field] == want[field], field
    # the LoRA delta shows: with zero qb/ob the port's tokens differ
    flat = tmodel.tree_map(lambda x: x, tp)
    flat["stacks"][0]["lora"][1] = tmodel.tree_map(torch.zeros_like,
                                                   tp["stacks"][0]["lora"][1])
    plain = lifecycle_trace(ServingEngine(tcfg, flat, engine_config(plane), seed=0,
                                          device="cpu"), tcfg.vocab)
    assert plain["tokens"] != got["tokens"]


def dtype_map(tree):
    return {k: str(v.dtype).replace("torch.", "") for k, v in _flatten(tree).items()
            if v is not None}


@pytest.mark.parametrize("build", ["init_params", "cast_tree"])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-350m"])
def test_bfloat16_tree_loss_matches_jax(arch, build):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    key = jax.random.PRNGKey(0)
    if build == "init_params":
        jp = jmodel.init_params(key, jcfg, dtype=jnp.bfloat16)
    else:
        jp = jnn.cast_tree(jmodel.init_params(key, jcfg), jnp.bfloat16)
    jp = perturb_lora(jp)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    lj, _ = jax.jit(lambda p, b: jmodel.loss_fn(p, jcfg, b))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    dtypes = {k: str(v.dtype) for k, v in _flatten(jp).items() if v is not None}
    assert dtype_map(tp) == dtypes
    if build == "init_params":
        assert "float32" in dtypes.values()  # mixed: the float32 leaves stay
        # the port's own bfloat16 tree keeps the same leaves float32
        assert dtype_map(tmodel.init_params(tcfg, torch.Generator().manual_seed(0),
                                            device="cpu", dtype=torch.bfloat16)) == dtypes
    lt, _ = tmodel.loss_fn(tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(lt) - float(lj)) <= 2.0 ** -8 * abs(float(lj)), (float(lt), float(lj))


def test_zamba2_state_checkpoints_with_its_none_blocks(tmp_path):
    """zamba2's training state (``None`` in ``blocks``, ``shared`` and
    ``lora``) round-trips through a checkpoint, leaf for leaf."""
    from repro_torch import optim
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import nn as tnn

    cfg = get_smoke_config("zamba2-2.7b")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tree = {"params": params, "opt": optim.init(params, optim.AdamWConfig())}
    assert "None" in tnn.tree_signature(params)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree, blocking=True)
    step, got = mgr.restore_latest(tree)
    assert step == 1 and tnn.tree_signature(got) == tnn.tree_signature(tree)
    for a, b in zip(tnn.tree_leaves(tree), tnn.tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
