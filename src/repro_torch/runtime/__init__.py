"""Distributed runtime: elastic re-meshing + straggler mitigation (the port
of ``repro/runtime``)."""
from repro_torch.runtime.elastic import ElasticMesh, Mesh, plan_mesh
from repro_torch.runtime.straggler import StragglerMonitor

__all__ = ["ElasticMesh", "Mesh", "plan_mesh", "StragglerMonitor"]
