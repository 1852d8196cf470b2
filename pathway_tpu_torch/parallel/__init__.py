"""Parallelism of the port (counterpart of ``pathway_tpu/parallel``),
single-process subset: the control plane (``distributed.py``), device
meshes (``mesh.py``) and serve-shard groups (``shards.py``)."""

from .distributed import broadcast_obj, is_coordinator
from .mesh import Mesh, current_mesh, data_axis_size, device_count, make_mesh, set_mesh
from .shards import FleetPartitionMap, ShardGroup, serve_shards

__all__ = [
    "FleetPartitionMap",
    "Mesh",
    "ShardGroup",
    "broadcast_obj",
    "current_mesh",
    "data_axis_size",
    "device_count",
    "is_coordinator",
    "make_mesh",
    "serve_shards",
    "set_mesh",
]
