"""Device meshes (the port of ``repro/launch/mesh.py``).

Functions, not module-level constants, so importing never touches
``torch.distributed``.  A mesh is a ``torch.distributed`` ``DeviceMesh``
over the ranks of the default process group: ``make_production_mesh``
needs 256 ranks (512 with ``multi_pod``).  The dry run gets them from
:func:`fake_process_group`, PyTorch's ``fake`` backend, which runs one
rank's program and answers every collective without a peer (the stand-in
for the JAX dry run's 512 emulated XLA host devices).
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def production_shape(multi_pod: bool = False):
    """``(shape, axis names)`` of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu") -> DeviceMesh:
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) ``("pod",
    "data", "model")`` with ``multi_pod``, over the default process group."""
    shape, axes = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(device_type: str = "cpu") -> DeviceMesh:
    """A ``(world, 1)`` mesh with the production axis names over every rank
    of the default process group (smoke tests)."""
    return init_device_mesh(device_type, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))


def mesh_num_devices(mesh: DeviceMesh) -> int:
    return int(mesh.size())


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0) -> Iterator[None]:
    """The default process group on the ``fake`` backend at ``world_size``,
    as ``rank``, torn down on exit.  Collectives return at once with their
    local inputs' shapes: the program of one rank of a mesh, without the
    mesh."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


__all__ = ["fake_process_group", "make_local_mesh", "make_production_mesh",
           "mesh_num_devices", "production_shape"]
