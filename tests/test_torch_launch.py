"""The port's distribution layer (``repro_torch.launch.mesh`` and
``.shardings``) against the JAX package's.

The rules of ``tests/test_launch.py`` (param specs, the alignment table,
the config transforms, ``input_specs``, ZeRO-1), then every spec held to
JAX's exactly, with no tolerance: for all ten configs on both production
meshes, every param leaf, the AdamW ``m``/``v``/``master`` after
``zero1_shardings``, the batch of every ``SHAPES`` cell and the decode
states at ``decode_32k`` and ``long_500k``.  The JAX side runs
``repro.launch.shardings`` on ``jax.sharding.AbstractMesh`` over
``jax.eval_shape(init_params ...)`` (no devices); its per-device shapes
come from ``NamedSharding.shard_shape``, and the port's per-device
argument bytes of each cell equal their sum.  The collective counter of
the dry-run is held to a row-sharded matmul whose all-reduce bytes,
FLOPs and bytes are known; the meshes leave ``torch.distributed`` as
they found it.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    batch_axes,
    make_fake_mesh,
    make_host_mesh,
    make_production_mesh,
    mesh_scope,
)
from repro_torch.models import nn  # noqa: E402
from repro_torch.models.model import init_decode_state, init_params  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def spec_of(path_names, shape, axis=16, q_align=True, kv_align=True):
    return sh.param_spec(path_names, shape, "model", axis,
                         q_align=q_align, kv_align=kv_align)


class TestParamSpecRules:
    def test_ffn_col_and_row(self):
        assert spec_of(["ffn", "wi_gate", "w"], (4096, 13696)) == (None, "model")
        assert spec_of(["ffn", "wo", "w"], (13696, 4096)) == ("model", None)

    def test_attention_head_aligned(self):
        # 32 q heads × 128 → aligned at 16
        assert spec_of(["attn", "wq", "w"], (4096, 4096)) == (None, "model")
        # kv misaligned (2 heads) → replicate even though 256 % 16 == 0
        assert spec_of(["attn", "wk", "w"], (4096, 256), kv_align=False) == ()
        # q misaligned (12 heads) → wq and wo replicate
        assert spec_of(["attn", "wq", "w"], (1536, 1536), q_align=False) == ()
        assert spec_of(["attn", "wo", "w"], (1536, 1536), q_align=False) == ()

    def test_moe_expert_parallel(self):
        assert spec_of(["moe", "wi_gate"], (16, 4096, 6400)) == ("model", None, None)
        assert spec_of(["moe", "wo"], (64, 1408, 2048)) == ("model", None, None)

    def test_embed_vocab_sharded(self):
        assert spec_of(["embed", "table"], (65024, 4096)) == ("model", None)
        # non-divisible vocab replicates
        assert spec_of(["embed", "table"], (65025, 4096)) == ()

    def test_norms_and_ssm_replicate(self):
        assert spec_of(["norm1", "scale"], (4096,)) == ()
        assert spec_of(["mixer", "in_proj", "w"], (2560, 10448)) == ()
        assert spec_of(["mixer", "wq", "w"], (2048, 2048)) == ()  # mLSTM

    def test_stacked_leading_dim_ignored(self):
        assert spec_of(["ffn", "wi_gate", "w"], (22, 2048, 5632)) == (None, None, "model")


@pytest.mark.parametrize("arch,q,kv", [
    ("chatglm3-6b", True, False),     # 32 q, 2 kv
    ("phi3-medium-14b", False, False),  # 40 q, 10 kv
    ("tinyllama-1.1b", True, False),  # 32 q, 4 kv
    ("gemma3-4b", False, False),      # 8 q, 4 kv
    ("musicgen-medium", False, False),  # 24 q MHA
    ("phi3.5-moe-42b-a6.6b", True, False),  # 32 q, 8 kv
    ("deepseek-v2-lite-16b", True, True),   # MLA 16 heads
    ("qwen2-vl-2b", False, False),    # 12 q, 2 kv
])
def test_alignment_table(arch, q, kv):
    assert sh.attn_alignment(get_config(arch), 16) == (q, kv)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MESHES["2x16x16"]
    assert sh.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements((), mesh) == (Replicate(),) * 3
    assert sh.shard_shape((("pod", "data"), "model"), (64, 32), mesh) == (2, 2)
    assert batch_axes(mesh) == ("pod", "data")


class TestConfigTransforms:
    def test_unrolled_preserves_layer_sequence(self):
        cfg = get_config("gemma3-4b")
        u = dryrun.unrolled(cfg)
        assert u.n_layers == cfg.n_layers == 34
        assert [s.attn.window for s in cfg.all_specs()] == [
            s.attn.window for s in u.all_specs()]

    def test_with_reps(self):
        assert dryrun.with_reps(get_config("zamba2-2.7b"), (2,)).n_layers == 12

    def test_input_specs_cover_every_cell(self):
        for arch in list_archs():
            cfg = get_config(arch)
            for shape, (seq, batch, kind) in SHAPES.items():
                if shape == "long_500k" and arch not in dryrun.LONG_OK:
                    continue
                specs = dryrun.input_specs(cfg, shape)
                tok = specs["tokens"]
                assert tok.device.type == "meta" and tok.shape[0] == batch
                if kind == "decode":
                    assert tok.shape[1] == 1
                    assert tuple(specs["cur_len"].shape) == (batch,)
                else:
                    assert tok.shape[1] == seq
                if cfg.vision_stub and kind != "decode":
                    assert "patch_embeds" in specs


def test_zero1_adds_data_axis_to_large_leaves():
    was = dist.is_initialized()
    with mesh_scope(make_host_mesh(device="cpu")) as mesh:
        assert tuple(mesh.mesh.shape) == (1, 1)
        big = torch.empty((1024, 4096), device="meta")
        small = torch.empty((64,), device="meta")
        shs = {"a": sh.Sharding((("data", 1), ("model", 1)), (None, None)),
               "b": sh.Sharding((("data", 1), ("model", 1)), ())}
        out = sh.zero1_shardings(shs, {"a": big, "b": small}, mesh, axis="data")
        assert out["a"].spec == ("data", None)
        assert out["b"].spec == ()  # small leaf untouched
    assert dist.is_initialized() == was


def test_meshes_restore_the_process_group_state():
    assert not dist.is_initialized()
    with mesh_scope(make_production_mesh()) as mesh:
        assert mesh.size() == 256 and mesh.mesh_dim_names == ("data", "model")
        # the same group again is reused, not reopened, and left up
        with mesh_scope(make_production_mesh()) as again:
            assert again.size() == 256
        assert dist.is_initialized()
        with pytest.raises(RuntimeError, match="already up"):
            make_production_mesh(multi_pod=True)
    assert not dist.is_initialized()
    with mesh_scope(make_production_mesh(multi_pod=True)) as mesh:
        assert tuple(mesh.mesh.shape) == (2, 16, 16)
    with mesh_scope(make_host_mesh(device="cpu")):
        with pytest.raises(RuntimeError, match="already up"):
            make_production_mesh()
    assert not dist.is_initialized()


def test_collective_counter_on_a_row_sharded_matmul():
    """``x (M, K) @ w (K, N)`` with the contraction dim split over a
    4-wide model axis: each device multiplies (M, K/4)·(K/4, N) and the
    partial sums are all-reduced, (M, N) float32 a device."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    M, K, N = 64, 256, 32
    with mesh_scope(make_fake_mesh({"data": 2, "model": 4})) as mesh:
        x = DTensor.from_local(torch.empty(M, K // 4, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        w = DTensor.from_local(torch.empty(K // 4, N, device="meta"), mesh,
                               [Replicate(), Shard(0)], run_check=False)
        with dryrun.CostCounter() as c:
            y = (x @ w).redistribute(mesh, [Replicate(), Replicate()])
        assert tuple(y.to_local().shape) == (M, N)
    got = c.result()
    assert got["collective_bytes"] == {"all-reduce": M * N * 4}
    assert got["collective_total"] == M * N * 4
    assert got["flops"] == 2 * M * (K // 4) * N
    assert got["bytes_accessed"] == (M * K // 4 + K // 4 * N + M * N) * 4


# --------------------------------------------------------------------- #
# every spec against JAX's
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def jax_params(arch):
    return jax.eval_shape(functools.partial(jmodel.init_params, cfg=jax_config(arch),
                                            dtype=jnp.bfloat16), jax.random.key(0))


@functools.lru_cache(maxsize=None)
def torch_params(arch):
    return init_params(get_config(arch), torch.Generator(), device="meta",
                       dtype=torch.bfloat16)


def jax_mesh(name):
    m = MESHES[name]
    return AbstractMesh(tuple(m.values()), tuple(m))


def jax_leaves(shardings, shapes):
    """``(path, spec, shard_shape, itemsize)`` of each JAX leaf."""
    specs = jax.tree_util.tree_leaves_with_path(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    shps = jax.tree_util.tree_leaves(shapes)
    assert len(specs) == len(shps)
    return [(jax.tree_util.keystr(p), tuple(s.spec), tuple(s.shard_shape(x.shape)),
             np.dtype(x.dtype).itemsize) for (p, s), x in zip(specs, shps)]


def torch_leaves(shardings, tree):
    specs = nn.tree_leaves_with_path(shardings) if not isinstance(shardings, sh.Sharding) \
        else [("", shardings)]
    leaves = nn.tree_leaves(tree)
    assert len(specs) == len(leaves)
    return [(p.replace("/", ""), s.spec, s.shard_shape(x.shape), x.element_size())
            for (p, s), x in zip(specs, leaves)]


def assert_same(jl, tl):
    assert [x[0] for x in jl] == [x[0] for x in tl]
    for j, t in zip(jl, tl):
        assert j == t, (j, t)


def jax_cell(arch, shape_name, mesh_name):
    """JAX's shardings of a cell's arguments, as leaf lists."""
    jcfg = jax_config(arch)
    mesh = jax_mesh(mesh_name)
    seq, batch, kind = SHAPES[shape_name]
    params = jax_params(arch)
    p_sh = jsh.shard_params(params, mesh, cfg=jcfg)
    out = [jax_leaves(p_sh, params)]
    if kind == "train":
        opt = jax.eval_shape(functools.partial(joptim.init, cfg=JAdamWConfig()), params)
        o_sh = jsh.shard_opt_state(opt, p_sh, mesh)
        for field in ("m", "v", "master"):
            out.append(jax_leaves(jsh.zero1_shardings(getattr(o_sh, field),
                                                      getattr(opt, field), mesh),
                                  getattr(opt, field)))
        out.append(jax_leaves(o_sh.step, opt.step))
    if kind == "decode":
        states = jax.eval_shape(functools.partial(
            jmodel.init_decode_state, cfg=jcfg, batch=batch, max_len=seq,
            dtype=jnp.bfloat16))
        out.append(jax_leaves(jsh.shard_decode_state(states, mesh), states))
    from repro.launch.dryrun import input_specs as jax_input_specs

    specs = jax_input_specs(jcfg, shape_name)
    out.append(jax_leaves(jsh.shard_batch(mesh, specs), specs))
    return out


def torch_cell(arch, shape_name, mesh_name):
    cfg = get_config(arch)
    mesh = MESHES[mesh_name]
    seq, batch, kind = SHAPES[shape_name]
    params = torch_params(arch)
    p_sh = sh.shard_params(params, mesh, cfg=cfg)
    out = [torch_leaves(p_sh, params)]
    if kind == "train":
        opt = optim.init(params, AdamWConfig())
        o_sh = sh.shard_opt_state(opt, p_sh, mesh)
        for field in ("m", "v", "master"):
            out.append(torch_leaves(sh.zero1_shardings(getattr(o_sh, field),
                                                       getattr(opt, field), mesh),
                                    getattr(opt, field)))
        out.append(torch_leaves(o_sh.step, opt.step))
    if kind == "decode":
        states = init_decode_state(cfg, batch, seq, dtype=torch.bfloat16, device="meta")
        out.append(torch_leaves(sh.shard_decode_state(states, mesh), states))
    specs = dryrun.input_specs(cfg, shape_name)
    out.append(torch_leaves(sh.shard_batch(mesh, specs), specs))
    return out


def cells():
    for arch in list_archs():
        for shape in SHAPES:
            if shape == "long_500k" and arch not in dryrun.LONG_OK:
                continue
            yield arch, shape


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_every_spec_equals_jax_exactly(arch, mesh_name):
    """Params, ZeRO-1 AdamW state, the batch of every SHAPES cell and the
    decode states of both decode cells (long_500k's too, whatever the
    arch), spec and per-device shape leaf for leaf; the per-device
    argument bytes of each cell the sum of JAX's."""
    for shape in SHAPES:
        jl, tl = jax_cell(arch, shape, mesh_name), torch_cell(arch, shape, mesh_name)
        assert len(jl) == len(tl)
        for j, t in zip(jl, tl):
            assert_same(j, t)
        if shape == "long_500k" and arch not in dryrun.LONG_OK:
            continue
        want = sum(int(np.prod(s)) * b for leaves in jl for _, _, s, b in leaves)
        got = dryrun.predicted_argument_bytes(get_config(arch), arch, SHAPES[shape],
                                              MESHES[mesh_name], torch.bfloat16)
        assert got == want, (shape, got, want)
        pinned = chip_smoke().DRYRUN_CELLS.get((arch, shape))
        if pinned is not None:  # the [dryrun] cells of chip_smoke.py
            assert pinned[list(MESHES).index(mesh_name)] == want


@functools.lru_cache(maxsize=None)
def chip_smoke():
    """``chip_smoke.py``'s constants (its ``main`` does not run on import)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_constants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_dryrun_cell_of_the_chip_smoke_is_pinned():
    cells = chip_smoke().DRYRUN_CELLS
    kinds = {SHAPES[shape][2] for _, shape in cells} | {shape for _, shape in cells}
    assert {"train", "prefill", "decode", "long_500k"} <= kinds
    families = {get_config(arch).family for arch, _ in cells}
    assert {"dense", "moe", "hybrid", "ssm"} <= families
    assert any(s.attn is not None and s.attn.is_mla
               for arch, _ in cells for s in get_config(arch).all_specs())
