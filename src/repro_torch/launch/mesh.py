"""Production mesh construction — port of ``repro/launch/mesh.py``.

Functions, not module constants, so importing this module touches no
process group.  Single pod: (data=16, model=16) = 256 devices.  Multi
pod: (pod=2, data=16, model=16) = 512 devices; the ``pod`` axis is pure
data parallelism.  The production meshes are built over a fake process
group of that many ranks (``torch.testing``'s ``FakeStore`` and the
"fake" backend), with this process as rank 0, so the dry-run needs no
hardware: its collectives return uninitialised tensors of the right
shapes.  :func:`destroy` tears the process group down.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (one
    already up at that size is kept)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, axes)


def make_fake_mesh(shape, axes) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over a fake process group of
    its size (meta-device programs: no hardware, no data)."""
    n = 1
    for s in shape:
        n *= s
    _fake_group(n)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_host_mesh(model: int = 1, data: int = 1) -> DeviceMesh:
    """A (data, model) mesh over the ranks of the process group the
    caller has initialised (or, with none, a one-rank group of this
    process: NCCL on a card, else gloo), ``model`` and ``data`` cut to
    the ranks there are."""
    kind = "cuda" if torch.cuda.is_available() else "cpu"
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    model = min(model, n)
    data = max(min(data, n // model), 1)
    return init_device_mesh(kind, (data, model),
                            mesh_dim_names=("data", "model"))


def destroy() -> None:
    """Tears down the process group a mesh was built over."""
    if dist.is_initialized():
        dist.destroy_process_group()
