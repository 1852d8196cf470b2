"""Parallelism of the port (counterpart of ``pathway_tpu/parallel``): the
control plane and data-plane collectives across processes
(``distributed.py``), device meshes within and across processes
(``mesh.py``) and serve-shard groups (``shards.py``)."""

from .distributed import barrier, broadcast_obj, is_coordinator, is_distributed, maybe_initialize
from .mesh import (
    Mesh,
    current_mesh,
    data_axis_size,
    device_count,
    is_multiprocess,
    local_shards,
    make_mesh,
    set_mesh,
)
from .shards import FleetPartitionMap, ShardGroup, serve_shards

__all__ = [
    "FleetPartitionMap",
    "Mesh",
    "ShardGroup",
    "barrier",
    "broadcast_obj",
    "current_mesh",
    "data_axis_size",
    "device_count",
    "is_coordinator",
    "is_distributed",
    "is_multiprocess",
    "local_shards",
    "make_mesh",
    "maybe_initialize",
    "serve_shards",
    "set_mesh",
]
