"""Elastic scaling: rebuild the device grid from the live device set (the
port of ``repro/runtime/elastic.py``).

The recovery loop is the JAX package's: a failure marks devices dead;
``plan_mesh`` picks the largest valid (data, model) grid from the surviving
device count (model axis preserved, data axis shrinks); the train state is
restored from the latest checkpoint; the data pipeline re-slices by the new
shard count.  ``plan_mesh`` is a copy of the JAX function.  The JAX package
builds a ``jax.sharding.Mesh``; here :class:`Mesh` is the grid, a numpy
object array of ``torch.device``s (one a rank) with its axis names, and,
when ``torch.distributed`` is up with as many ranks as the grid holds, the
``DeviceMesh`` over those ranks (``device_mesh``), on which the sharding
plan lays tensors out (``models/sharding.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def plan_mesh(
    num_devices: int, model_parallel: int, pods: int = 1
) -> tuple:
    """Largest (pod, data, model) grid for the surviving device count.

    The model axis is preserved (weight shardings depend on it); whole
    data-parallel rows are dropped; pods shrink last."""
    assert model_parallel >= 1
    while pods >= 1:
        per_pod = num_devices // pods
        data = per_pod // model_parallel
        if data >= 1:
            return pods, data, model_parallel
        pods -= 1
    raise ValueError(
        f"{num_devices} devices cannot host model_parallel={model_parallel}"
    )


@dataclasses.dataclass
class Mesh:
    """A device grid: ``devices`` of shape ``(data, model)`` or ``(pod,
    data, model)``, named by ``axis_names``; ``device_mesh`` the
    ``torch.distributed`` mesh over the same ranks, or ``None`` outside a
    process group of that size."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    device_mesh: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def _device_id(d) -> int:
    """The id of a dead device given as an id, a dict with ``"id"`` or a
    device (its index)."""
    if isinstance(d, dict):
        return d["id"]
    if isinstance(d, torch.device):
        return d.index or 0
    return d


@dataclasses.dataclass
class ElasticMesh:
    model_parallel: int
    pods: int = 1
    mesh: Optional[Mesh] = None
    devices: List[torch.device] = dataclasses.field(default_factory=list)  # of the last build

    def build(self, devices: Optional[Sequence[torch.device]] = None) -> Mesh:
        """The grid over ``devices`` (default: every CUDA device)."""
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self.devices = list(devices)
        pods, data, model = plan_mesh(len(self.devices), self.model_parallel, self.pods)
        arr = np.empty(pods * data * model, dtype=object)
        arr[:] = self.devices[: pods * data * model]
        arr = arr.reshape(pods, data, model)
        if pods > 1:
            self.mesh = Mesh(arr, ("pod", "data", "model"))
        else:
            self.mesh = Mesh(arr.reshape(data, model), ("data", "model"))
        if dist.is_initialized() and dist.get_world_size() == arr.size:
            from torch.distributed.device_mesh import init_device_mesh

            self.mesh.device_mesh = init_device_mesh(
                self.devices[0].type, self.mesh.devices.shape, mesh_dim_names=self.mesh.axis_names)
        return self.mesh

    def on_failure(self, dead: Sequence) -> Mesh:
        """Rebuild the grid from the devices of the last ``build`` (every
        CUDA device before one) without the dead ones (ids, dicts with
        ``"id"``, or devices)."""
        dead_set = {_device_id(d) for d in dead}
        if self.mesh is None:
            self.build()
        return self.build([d for d in self.devices if _device_id(d) not in dead_set])

    @property
    def data_shards(self) -> int:
        assert self.mesh is not None
        shape = self.mesh.shape
        return shape.get("data", 1) * shape.get("pod", 1)
