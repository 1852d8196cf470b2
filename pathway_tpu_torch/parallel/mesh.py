"""Device meshes (counterpart of ``pathway_tpu/parallel/mesh.py``).

A ``Mesh`` is a grid of ``torch.device``s with named axes, by default
``("data", "model")``: "data" splits index rows (``DeviceKnnIndex(mesh=...)``
keeps one row block per data shard on that shard's device) and encoder
batches (``SentenceEncoder(mesh=...)``), "model" is the tensor-parallel
axis.  Ring attention takes a one-axis mesh such as ``("sp",)``
(``ops/ring_attention.py``).  The grid needs ``n_data * n_model``
devices, as the reference checks; a caller may list one device more than
once (``[cpu] * 8`` in the tests, ``[cuda:0] * 8`` on one card), which
is how shards outnumber devices.  ``PATHWAY_TPU_DATA_SHARDS`` /
``PATHWAY_TPU_MODEL_SHARDS`` override the axis sizes
(``parallel.data_shards`` / ``parallel.model_shards``).

Across processes (``parallel/distributed.py``): after
``maybe_initialize``, ``make_mesh`` lists every rank's devices in rank
order, and each index along the first axis records the rank that owns
it (``owners``).  ``is_multiprocess`` is True when some shard belongs to
another rank; every rank then owns the same number of shards.
``host_to_global`` / ``global_zeros`` return one entry per data shard:
a tensor on the shard's device where this rank owns it, else None.  As
in the reference, every SPMD replica holds the full host value and
places only its own blocks.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import config
from ..device import default_device
from . import distributed

__all__ = [
    "Mesh",
    "current_mesh",
    "data_axis_size",
    "device_count",
    "gather_shards",
    "global_zeros",
    "host_to_global",
    "is_multiprocess",
    "local_shards",
    "make_mesh",
    "set_mesh",
]


def _nested(grid, depth: int):
    if depth == 1:
        return [torch.device(d) for d in grid]
    return [_nested(row, depth - 1) for row in grid]


class Mesh:
    """A grid of devices, nested one list per axis of ``axis_names``;
    ``shape`` maps each axis name to its size, and ``owners[i]`` is the
    rank that owns index ``i`` of the first axis (this process's rank
    for every index unless given)."""

    def __init__(self, grid, axis_names: Sequence[str] = ("data", "model"), owners: Optional[Sequence[int]] = None):
        self.axis_names = tuple(axis_names)
        self.devices = _nested(grid, len(self.axis_names))
        sizes, level = [], self.devices
        for _ in self.axis_names:
            sizes.append(len(level))
            level = level[0]
        self.shape = dict(zip(self.axis_names, sizes))
        n = sizes[0]
        self.owners = [distributed.process_id()] * n if owners is None else [int(o) for o in owners]
        if len(self.owners) != n:
            raise ValueError(f"{len(self.owners)} owners for {n} indices of axis {self.axis_names[0]!r}")
        counts = {r: self.owners.count(r) for r in set(self.owners)}
        if len(set(counts.values())) > 1:
            raise ValueError(f"ranks own unequal numbers of shards: {counts}")

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, every other axis at index 0."""
        at = self.axis_names.index(axis)
        out = []
        for i in range(self.shape[axis]):
            d = self.devices
            for j in range(len(self.axis_names)):
                d = d[i if j == at else 0]
            out.append(d)
        return out

    def data_device(self, shard: int) -> torch.device:
        """The device of index ``shard`` of the first axis (the data
        shard, at model column 0)."""
        d = self.devices[shard]
        while isinstance(d, list):
            d = d[0]
        return d

    def __repr__(self) -> str:
        return "Mesh(" + ", ".join(f"{a}={n}" for a, n in self.shape.items()) + ")"


_lock = threading.Lock()
_current_mesh: Optional[Mesh] = None


def device_count() -> int:
    """Visible CUDA devices (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A ``("data", "model")`` mesh over ``devices`` (every visible CUDA
    device when None; raises without CUDA).  Defaults: every device on
    the data axis, model axis 1.  In a process cluster ``devices`` are
    this rank's, and the mesh lists every rank's in rank order (a
    collective: every rank calls it)."""
    if devices is None and default_device() != "cuda":
        devices = [torch.device(default_device())]  # a process default set to the CPU (cli run --device cpu)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=[...] explicitly to build a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    owners = [distributed.process_id()] * len(devices)
    if distributed.is_distributed():
        lists = distributed.gather_obj([str(d) for d in devices])
        devices = [torch.device(d) for lst in lists for d in lst]
        owners = [r for r, lst in enumerate(lists) for _ in lst]
    n_model = config.get("parallel.model_shards") or n_model
    if n_data is None:
        n_data = config.get("parallel.data_shards") or len(devices) // n_model
    needed = n_data * n_model
    if needed > len(devices) or needed < 1:
        raise ValueError(f"mesh {n_data}x{n_model} needs {needed} devices, have {len(devices)}")
    rows = [range(r * n_model, (r + 1) * n_model) for r in range(n_data)]
    row_owners = []
    for r in rows:
        ranks = {owners[i] for i in r}
        if len(ranks) != 1:
            raise ValueError(f"data shard {r.start // n_model} spans the devices of ranks {sorted(ranks)}")
        row_owners.append(ranks.pop())
    return Mesh([[devices[i] for i in r] for r in rows], owners=row_owners)


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
    """True when some index of the mesh's first axis belongs to another
    process."""
    me = distributed.process_id()
    return any(o != me for o in mesh.owners)


def local_shards(mesh: Mesh) -> List[int]:
    """The first-axis indices this process owns, ascending."""
    me = distributed.process_id()
    return [s for s, o in enumerate(mesh.owners) if o == me]


def host_to_global(value, mesh: Mesh, rows: bool = True) -> List[Optional[torch.Tensor]]:
    """Host data on the mesh, one entry per data shard: row blocks split
    evenly over the data axis (``rows``), or a copy on every data
    device; None for a shard another process owns."""
    t = torch.from_numpy(np.ascontiguousarray(value))
    n = mesh.shape["data"]
    if rows:
        if t.shape[0] % n:
            raise ValueError(f"{t.shape[0]} rows do not split over {n} data shards")
        parts = t.chunk(n)
    else:
        parts = [t] * n
    mine = set(local_shards(mesh))
    return [p.to(mesh.data_device(s)) if s in mine else None for s, p in enumerate(parts)]


def global_zeros(shape, dtype: torch.dtype, mesh: Mesh, rows: bool = True) -> List[Optional[torch.Tensor]]:
    """Zeros on the mesh, one entry per data shard (row blocks of
    ``shape`` when ``rows``, else a full copy on every data device);
    None for a shard another process owns."""
    n = mesh.shape["data"]
    shape = tuple(shape)
    if rows:
        if shape[0] % n:
            raise ValueError(f"{shape[0]} rows do not split over {n} data shards")
        shape = (shape[0] // n,) + shape[1:]
    mine = set(local_shards(mesh))
    return [torch.zeros(shape, dtype=dtype, device=mesh.data_device(s)) if s in mine else None for s in range(n)]


def gather_shards(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """``[S, ...]`` in global shard order from this process's
    ``[S_local, ...]`` (its shards ascending): one ``all_gather`` on a
    mesh across processes, ``local`` itself otherwise."""
    if not is_multiprocess(mesh):
        return local
    got = distributed.all_gather(local)  # [world, S_local, ...]
    order = [s for r in range(distributed.process_count()) for s, o in enumerate(mesh.owners) if o == r]
    out = torch.empty((len(order),) + tuple(local.shape[1:]), dtype=local.dtype, device=local.device)
    out[torch.as_tensor(order, device=local.device)] = got.reshape(out.shape)
    return out
