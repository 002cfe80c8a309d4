"""The port's dry-run (``repro_torch.launch.dryrun``) and ``remat_policy``.

A dry-run of smoke tinyllama-1.1b and smoke phi3.5-moe (train, prefill,
decode) on a fake (2, 2) mesh: every cell ``ok``; its per-device FLOPs
lie between the same step's count on plain ``meta`` tensors (the global
count) over the four devices and that count, and equal a quarter of it
exactly where the layout splits every matmul four ways (tinyllama's
prefill and decode); its per-device argument bytes are the local
shards' and the placements' prediction; and ``torch.distributed`` is
left as it was.

``remat_policy="dots"`` on the CPU for the ten smoke configs: the loss
and every gradient equal ``remat=True``'s bit for bit and JAX's
``loss_fn(..., remat=True, remat_policy=dots_with_no_batch_dims_saveable)``
within ``test_torch_train_models.py``'s tolerances; counted in a
dispatch mode, the backward under ``"dots"`` runs no more ``aten.mm``
than without remat, where ``remat=True`` recomputes them.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_smoke_config, list_archs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import nn as tnn  # noqa: E402
from test_torch_train_models import (  # noqa: E402
    LOSS_TOL,
    assert_grads_close,
    make_batch,
    model_pair,
    torch_value_and_grad,
)

MESH = {"data": 2, "model": 2}
# (seq, batch, kind): train and prefill longer than the CE chunk (512)
# and qwen2-vl's 256 patches; every batch divides the data axis twice
SMALL = {"train": (512, 8, "train"), "prefill": (512, 4, "prefill"),
         "decode": (64, 8, "decode")}


@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "phi3.5-moe-42b-a6.6b"])
def test_small_dry_run_counts_per_device(arch, kind):
    cfg = get_smoke_config(arch)
    was = dist.is_initialized()
    r = dryrun.run_cell(arch, kind, cfg=cfg, mesh_shape=MESH, shape=SMALL[kind],
                        verbose=False)
    assert dist.is_initialized() == was
    assert r["status"] == "ok" and r["n_devices"] == 4 and r["mesh"] == "2x2"
    assert r["cost_mode"] == "traced"

    # the same step on plain meta tensors: the global count
    kind, inputs, _ = dryrun.step_inputs(cfg, arch, kind, MESH, torch.bfloat16, SMALL[kind])
    plain, _, _ = dryrun.count_step(kind, cfg, arch, inputs)
    assert plain["collective_total"] == 0 and plain["flops"] > 0
    # per device: no more than all of it, no less than an even share; the
    # dense inference steps split every matmul over all four devices (rows
    # over data; heads, FFN columns and vocab over model), exactly
    assert plain["flops"] / 4 <= r["flops"] <= plain["flops"]
    if arch == "tinyllama-1.1b" and kind != "train":
        assert r["flops"] * 4 == plain["flops"]
    assert r["bytes_accessed"] > 0
    want = dryrun.predicted_argument_bytes(cfg, arch, SMALL[kind], MESH, torch.bfloat16)
    assert r["argument_size_in_bytes"] == want
    assert r["output_size_in_bytes"] > 0
    # the batch is split over data, the weights over model: something moves
    assert r["collective_total"] == sum(r["collective_bytes"].values()) > 0


def test_skipped_cell_and_cli_summary(capsys, tmp_path, monkeypatch):
    r = dryrun.run_cell("tinyllama-1.1b", "long_500k", verbose=False)
    assert r["status"] == "skipped" and r["mesh"] == "16x16"
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "phi3-medium-14b",
                                     "--shape", "long_500k", "--both-meshes",
                                     "--out", str(tmp_path / "r.json")])
    dryrun.main()
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == "dry-run: 0 ok, 2 skipped, 0 FAILED / 2"


# --------------------------------------------------------------------- #
# remat_policy="dots"
# --------------------------------------------------------------------- #
class MmCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def backward_mms(tcfg, tp, batch, **kw):
    leaves = tnn.tree_leaves(tp)
    req = [x.detach().requires_grad_(True) for x in leaves]
    loss, _ = tmodel.loss_fn(tnn.tree_unflatten(tp, req), tcfg, batch, **kw)
    with MmCounter() as c:
        torch.autograd.grad(loss, req, allow_unused=True)
    return c.n


@pytest.mark.parametrize("arch", list_archs())
def test_dots_policy_equals_remat_and_jax(arch):
    _, _, tcfg, tp = model_pair(arch)
    np_batch = make_batch(tcfg)  # the batch of the module's JAX parity tests
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    (l1, _), g1 = torch_value_and_grad(
        lambda p: tmodel.loss_fn(p, tcfg, batch, remat=True), tp)
    (l2, _), g2 = torch_value_and_grad(
        lambda p: tmodel.loss_fn(p, tcfg, batch, remat=True, remat_policy="dots"), tp)
    assert torch.equal(l1, l2)
    for a, b in zip(tnn.tree_leaves(g1), tnn.tree_leaves(g2)):
        assert torch.equal(a, b)

    policy = jax.checkpoint_policies.dots_with_no_batch_dims_saveable
    jcfg, jp, _, _ = model_pair(arch)
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jcfg, b, remat=True, remat_policy=policy),
        has_aux=True))(jp, {k: jax.numpy.asarray(v) for k, v in np_batch.items()})
    assert abs(float(l2) - float(lj)) <= LOSS_TOL
    assert_grads_close(gj, g2, arch)

    plain = backward_mms(tcfg, tp, batch)
    full = backward_mms(tcfg, tp, batch, remat=True)
    dots = backward_mms(tcfg, tp, batch, remat=True, remat_policy="dots")
    assert dots == plain < full


def test_unknown_remat_policy_names_the_accepted_ones():
    _, _, tcfg, tp = model_pair("tinyllama-1.1b")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(tcfg).items()}
    with pytest.raises(ValueError, match=r"\(None, 'dots'\)"):
        tmodel.loss_fn(tp, tcfg, batch, remat=True, remat_policy="everything")


@pytest.mark.parametrize("tp", [2, 4])
def test_gqa_core_on_a_devices_query_heads_equals_the_whole(tp):
    """A device that holds ``H / tp`` query heads and every KV head picks
    the KV heads of its own: its output is its heads' share of the
    whole, exactly (smoke tinyllama: 8 query heads, 2 KV heads)."""
    import functools

    from repro_torch.models import attention as tattn

    cfg = get_smoke_config("tinyllama-1.1b").all_specs()[0].attn
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator().manual_seed(0)
    B, S = 2, 12
    q, k, v = (torch.randn(B, S, n * D, generator=gen) for n in (H, Hkv, Hkv))
    cos, sin = tattn.make_cos_sin(cfg, torch.arange(S)[None].expand(B, S))
    core = functools.partial(tattn._gqa_core, cfg, tattn.chunked_attention)
    whole = core(0, q, k, v, cos, sin)
    w = H // tp * D
    for r in range(tp):
        part = core(r, q[..., r * w:(r + 1) * w], k, v, cos, sin)
        assert torch.equal(part, whole[..., r * w:(r + 1) * w])


def test_dryrun_update_merges_rerun_cells(tmp_path):
    """``dryrun_update`` replaces a cell's rows on both meshes and keeps
    the others (a skipped cell runs no trace)."""
    import json

    from repro_torch.launch import dryrun_update

    out = tmp_path / "results.json"
    keep = {"arch": "gemma3-4b", "shape": "train_4k", "mesh": "16x16", "status": "ok"}
    stale = {"arch": "tinyllama-1.1b", "shape": "long_500k", "mesh": "16x16",
             "status": "FAILED"}
    out.write_text(json.dumps([keep, stale]))
    dryrun_update.main(["--cells", "tinyllama-1.1b:long_500k", "--out", str(out)])
    rows = json.loads(out.read_text())
    assert rows[0] == keep
    assert [(r["mesh"], r["status"]) for r in rows[1:]] == [("16x16", "skipped"),
                                                            ("2x16x16", "skipped")]
