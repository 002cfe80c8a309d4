"""Device meshes over ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).

* :func:`make_production_mesh`: the production layout, (data=16,
  model=16) for one pod of 256 devices or (pod=2, data=16, model=16) for
  512, as a ``DeviceMesh`` over a **fake** process group of that many
  ranks (the ``"fake"`` backend with ``FakeStore``, as PyTorch's own
  memory and FLOP estimators use it): this process plays rank 0, and a
  collective returns at once without moving data.  The dry-run places
  ``meta`` tensors on it.  Its device type is ``cuda``, the production
  devices', which no collective touches (so DTensor reshards a dim with
  an all-to-all, not the all-gather it takes on a CPU mesh); it needs no
  card.
* :func:`make_fake_mesh`: any named mesh over such a group (the tests'
  small ones).
* :func:`make_host_mesh`: the degenerate ``(n // mp, mp)`` mesh over the
  devices this process drives, a real group: ``nccl`` for the card,
  ``gloo`` for ``device="cpu"``, both over an in-process ``HashStore``
  (no network).  One process drives one device, so ``n`` is 1 unless a
  group of ``n`` ranks is already up.
* :func:`batch_axes`: the mesh axes that shard the batch dimension.

One process holds one default group.  Nothing is opened at import; a
mesh maker opens the group it needs when none is up, reuses one of the
same backend and size, and raises when another is up.
:func:`close_mesh` destroys the group only if its maker opened it, so a
caller that pairs the two (``with mesh_scope(make_production_mesh()) as
mesh:``) leaves ``torch.distributed.is_initialized()`` as it found it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: ids of the meshes whose maker opened the default group
_OPENED: set = set()


def _open_group(backend: str, world_size: int) -> bool:
    """Open the default group, or check the one that is up.  Returns
    whether this call opened it."""
    if dist.is_initialized():
        up = (dist.get_backend(), dist.get_world_size())
        if up != (backend, world_size):
            raise RuntimeError(
                f"a {up[0]} group of {up[1]} ranks is already up; this mesh "
                f"needs a {backend} group of {world_size}: destroy the other first")
        return False
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore

        store = FakeStore()
    else:
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=0, world_size=world_size)
    return True


def _mesh(device_type: str, backend: str, shape: Tuple[int, ...],
          names: Tuple[str, ...]) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= s
    opened = _open_group(backend, n)
    try:
        mesh = init_device_mesh(device_type, shape, mesh_dim_names=names)
    except BaseException:
        if opened:
            dist.destroy_process_group()
        raise
    if opened:
        _OPENED.add(id(mesh))
    return mesh


def make_fake_mesh(axes: Dict[str, int]) -> DeviceMesh:
    """A mesh of the named ``{axis: size}`` dims, in order, over a fake
    group of their product's ranks."""
    return _mesh("cuda", "fake", tuple(axes.values()), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(16, 16) ``("data", "model")`` or (2, 16, 16) ``("pod", "data",
    "model")`` over a fake group of 256 or 512 ranks."""
    if multi_pod:
        return make_fake_mesh({"pod": 2, "data": 16, "model": 16})
    return make_fake_mesh({"data": 16, "model": 16})


def make_host_mesh(model_parallel: int = 1, device: str = "cuda") -> DeviceMesh:
    """Degenerate ``(n // model_parallel, model_parallel)`` mesh over the
    local devices: the card (``nccl``) unless ``device="cpu"`` (``gloo``)."""
    dev = torch.device(device).type
    backend = "nccl" if dev == "cuda" else "gloo"
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % model_parallel:
        raise ValueError(f"{n} devices do not split into model_parallel={model_parallel}")
    return _mesh(dev, backend, (n // model_parallel, model_parallel), ("data", "model"))


def close_mesh(mesh: DeviceMesh) -> None:
    """Destroy the default group if ``mesh``'s maker opened it."""
    if id(mesh) in _OPENED:
        _OPENED.discard(id(mesh))
        dist.destroy_process_group()


@contextlib.contextmanager
def mesh_scope(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """``mesh`` for the body; :func:`close_mesh` on the way out."""
    try:
        yield mesh
    finally:
        close_mesh(mesh)


def batch_axes(mesh) -> tuple:
    """Mesh axes that shard the batch dimension (``mesh`` a ``DeviceMesh``
    or a ``{axis: size}`` dict)."""
    names = tuple(mesh) if isinstance(mesh, dict) else mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)
