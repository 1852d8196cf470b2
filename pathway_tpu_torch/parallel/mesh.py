"""Device meshes (counterpart of ``pathway_tpu/parallel/mesh.py``).

A ``Mesh`` is a ``("data", "model")`` grid of ``torch.device``s: "data"
splits index rows (``DeviceKnnIndex(mesh=...)`` keeps one row block per
data shard on that shard's device), "model" is the tensor-parallel axis.
The grid needs ``n_data * n_model`` devices, as the reference checks; a
caller may list one device more than once (``[cpu] * 8`` in the tests,
``[cuda:0] * 8`` on one card), which is how shards outnumber devices.
``PATHWAY_TPU_DATA_SHARDS`` / ``PATHWAY_TPU_MODEL_SHARDS`` override the
axis sizes (``parallel.data_shards`` / ``parallel.model_shards``).

Single-process meshes only: ``is_multiprocess`` is False, and
``host_to_global`` / ``global_zeros`` place host data and zeros as one
tensor per data shard on that shard's device.  Meshes spanning several
processes (``torch.distributed``) are not ported yet.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import config

__all__ = [
    "Mesh",
    "current_mesh",
    "data_axis_size",
    "device_count",
    "global_zeros",
    "host_to_global",
    "is_multiprocess",
    "make_mesh",
    "set_mesh",
]


class Mesh:
    """A ``[n_data][n_model]`` grid of devices with the reference's axis
    names; ``shape`` maps each axis name to its size."""

    axis_names = ("data", "model")

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.devices: List[List[torch.device]] = [[torch.device(d) for d in row] for row in grid]
        self.shape = {"data": len(self.devices), "model": len(self.devices[0])}

    def data_device(self, shard: int) -> torch.device:
        """The device of data shard ``shard`` (model column 0)."""
        return self.devices[shard][0]

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']})"


_lock = threading.Lock()
_current_mesh: Optional[Mesh] = None


def device_count() -> int:
    """Visible CUDA devices (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A ``("data", "model")`` mesh over ``devices`` (every visible CUDA
    device when None; raises without CUDA).  Defaults: every device on
    the data axis, model axis 1."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=[...] explicitly to build a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n_model = config.get("parallel.model_shards") or n_model
    if n_data is None:
        n_data = config.get("parallel.data_shards") or len(devices) // n_model
    needed = n_data * n_model
    if needed > len(devices) or needed < 1:
        raise ValueError(f"mesh {n_data}x{n_model} needs {needed} devices, have {len(devices)}")
    return Mesh([devices[r * n_model : (r + 1) * n_model] for r in range(n_data)])


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _current_mesh
    with _lock:
        _current_mesh = mesh


def current_mesh(create: bool = True) -> Optional[Mesh]:
    """The process-wide mesh (made lazily over every device)."""
    global _current_mesh
    with _lock:
        if _current_mesh is None and create:
            _current_mesh = make_mesh()
        return _current_mesh


def data_axis_size(mesh: Optional[Mesh] = None) -> int:
    return (mesh or current_mesh()).shape["data"]


def is_multiprocess(mesh: Mesh) -> bool:
    """Always False: every device of a port mesh belongs to this process."""
    return False


def host_to_global(value, mesh: Mesh, rows: bool = True) -> List[torch.Tensor]:
    """Host data on the mesh, one tensor per data shard: row blocks split
    evenly over the data axis (``rows``), or a copy on every data
    device."""
    t = torch.from_numpy(np.ascontiguousarray(value))
    n = mesh.shape["data"]
    if rows:
        if t.shape[0] % n:
            raise ValueError(f"{t.shape[0]} rows do not split over {n} data shards")
        parts = t.chunk(n)
    else:
        parts = [t] * n
    return [p.to(mesh.data_device(s)) for s, p in enumerate(parts)]


def global_zeros(shape, dtype: torch.dtype, mesh: Mesh, rows: bool = True) -> List[torch.Tensor]:
    """Zeros on the mesh, one tensor per data shard (row blocks of
    ``shape`` when ``rows``, else a full copy on every data device)."""
    n = mesh.shape["data"]
    shape = tuple(shape)
    if rows:
        if shape[0] % n:
            raise ValueError(f"{shape[0]} rows do not split over {n} data shards")
        shape = (shape[0] // n,) + shape[1:]
    return [torch.zeros(shape, dtype=dtype, device=mesh.data_device(s)) for s in range(n)]
