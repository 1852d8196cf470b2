"""Parallelism of the port (counterpart of ``pathway_tpu/parallel``): the
control plane and data-plane collectives across processes
(``distributed.py``), device meshes within and across processes
(``mesh.py``), serve-shard groups (``shards.py``), and the host
exchange (``exchange.py``): the engine's ``ExchangePlane`` between ranks
and the serve fabric's authenticated frame stream."""

from . import distributed
from .distributed import barrier, broadcast_obj, is_coordinator, is_distributed, maybe_initialize
from .mesh import (
    Mesh,
    current_mesh,
    data_axis_size,
    device_count,
    global_zeros,
    host_to_global,
    is_multiprocess,
    local_shards,
    make_mesh,
    set_mesh,
)
from .exchange import ExchangePlane, FramedStream, PeerLost, close_plane, gather_table_rows, get_plane
from .shards import FleetPartitionMap, ShardGroup, serve_shards

__all__ = [
    "ExchangePlane",
    "FleetPartitionMap",
    "FramedStream",
    "Mesh",
    "PeerLost",
    "ShardGroup",
    "barrier",
    "broadcast_obj",
    "close_plane",
    "current_mesh",
    "data_axis_size",
    "device_count",
    "distributed",
    "gather_table_rows",
    "get_plane",
    "global_zeros",
    "host_to_global",
    "is_coordinator",
    "is_distributed",
    "is_multiprocess",
    "local_shards",
    "make_mesh",
    "maybe_initialize",
    "serve_shards",
    "set_mesh",
]
