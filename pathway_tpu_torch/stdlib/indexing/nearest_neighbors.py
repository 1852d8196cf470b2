"""Vector index implementations + factories of the port (counterpart of
``pathway_tpu/stdlib/indexing/nearest_neighbors.py``; reference:
stdlib/indexing/nearest_neighbors.py:65-262 — USearchKnn, BruteForceKnn,
LshKnn wrappers over native indexes).

Every dense variant is backed by a device-resident index of the port:
``DeviceKnnIndex`` (ops/knn.py, exact scoring by tensor-core matmuls)
or ``IvfKnnIndex`` (ops/ivf.py, whose probed shortlist rescore is the
hand-written CUDA kernel ``csrc/ivf_rescore.cu``), or, for ``LshKnn``,
host buckets with a device rescore (``stdlib/ml/_knn_lsh.py``); ``TpuKnn`` shards rows
over the port's mesh (``parallel.current_mesh()``, a mesh of one on one
card).  Indexes run on the CUDA device unless ``device="cpu"`` is passed;
a factory's ``device`` reaches the index it builds.  The reference class
names are kept as aliases so templates/configs port unchanged."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops.knn import DeviceKnnIndex, normalize_metric
from .filters import compile_filter

__all__ = [
    "InnerIndexImpl",
    "DeviceKnn",
    "DeviceIvfKnn",
    "DeviceLshKnn",
    "IvfKnn",
    "BruteForceKnn",
    "TpuKnn",
    "USearchKnn",
    "LshKnn",
    "BruteForceKnnFactory",
    "TpuKnnFactory",
    "UsearchKnnFactory",
    "IvfKnnFactory",
    "LshKnnFactory",
]


class InnerIndexImpl:
    """Protocol consumed by ExternalIndexOperator."""

    def add(self, keys: Sequence[int], values: Sequence[Any], metadatas: Sequence[Any]) -> None:
        raise NotImplementedError

    def remove(self, keys: Sequence[int]) -> None:
        raise NotImplementedError

    def search(
        self, values: Sequence[Any], k: int, filters: Sequence[Optional[str]]
    ) -> List[Tuple[Tuple[int, float], ...]]:
        raise NotImplementedError


class DeviceKnn(InnerIndexImpl):
    """Dense KNN on device with host-side metadata filtering
    (oversampled filtered search keeps scoring on the device)."""

    def __init__(
        self,
        dimension: int,
        metric: str = "cos",
        mesh=None,
        initial_capacity: int = 1024,
        dtype=None,
        device=None,
    ):
        self.index = DeviceKnnIndex(
            dimension=dimension,
            metric=metric,
            initial_capacity=initial_capacity,
            mesh=mesh,
            dtype=dtype or torch.float32,
            device=device,
        )
        self.metadata: Dict[int, Any] = {}

    def add(self, keys, values, metadatas) -> None:
        vectors = np.array([np.asarray(v, dtype=np.float32) for v in values])
        self.index.add(keys, vectors)
        for key, md in zip(keys, metadatas):
            if md is not None:
                self.metadata[int(key)] = md

    def remove(self, keys) -> None:
        self.index.remove(keys)
        for key in keys:
            self.metadata.pop(int(key), None)

    def search(self, values, k, filters):
        vectors = np.array([np.asarray(v, dtype=np.float32) for v in values])
        if all(f is None for f in filters):
            rows = self.index.search(vectors, k)
            return [tuple(row) for row in rows]
        out: List[Tuple[Tuple[int, float], ...]] = []
        for vec, fexpr in zip(vectors, filters):
            if fexpr is None:
                out.append(tuple(self.index.search(vec[None, :], k)[0]))
                continue
            accept_fn = compile_filter(str(fexpr))
            rows = self.index.search_oversampled(
                vec[None, :],
                k,
                accept=lambda key: accept_fn(self.metadata.get(int(key), {})),
            )
            out.append(tuple(rows[0]))
        return out


class DeviceIvfKnn(DeviceKnn):
    """Approximate KNN for corpora past the exact index's comfort zone
    (>~1M rows): IVF probing with exact shortlist rescore (ops/ivf.py).
    Inherits DeviceKnn's add/remove/search incl. oversampled metadata
    filtering — IvfKnnIndex exposes the same host API as DeviceKnnIndex."""

    def __init__(
        self,
        dimension: int,
        metric: str = "cos",
        n_clusters: Optional[int] = None,
        n_probe: Optional[int] = None,
        device=None,
    ):
        from ...ops.ivf import IvfKnnIndex

        self.index = IvfKnnIndex(
            dimension=dimension,
            metric=metric,
            n_clusters=n_clusters,
            n_probe=n_probe,
            device=device,
        )
        self.metadata: Dict[int, Any] = {}


# Factories (reference: stdlib/indexing/retrievers.py style factories used by
# DocumentStore/VectorStore; make() is called once per query operator)
class _DeviceKnnFactory:
    metric = "cos"
    sharded = False

    def __init__(
        self,
        dimension: Optional[int] = None,
        reserved_space: int = 1024,
        metric: Optional[str] = None,
        embedder=None,
        mesh=None,
        device=None,
        **kwargs,
    ):
        self.dimension = dimension
        self.reserved_space = reserved_space
        if metric is not None:
            self.metric = normalize_metric(metric)
        self.embedder = embedder
        self.mesh = mesh
        self.device = device

    def build_inner_index(self, dimension: Optional[int] = None) -> DeviceKnn:
        dim = dimension or self.dimension
        if dim is None:
            raise ValueError("index factory needs the embedding dimension")
        mesh = self.mesh
        if self.sharded and mesh is None:
            from ...parallel import current_mesh, make_mesh

            # the process-wide mesh over the cards, or a mesh of one on the
            # device the caller named
            mesh = current_mesh() if self.device is None else make_mesh(1, 1, devices=[self.device])
        inner = DeviceKnn(
            dimension=dim,
            metric=self.metric,
            mesh=mesh,
            initial_capacity=self.reserved_space,
            device=None if mesh is not None else self.device,
        )
        if self.embedder is not None:
            # text columns are embedded (batched) at add/search time
            from .embedding_adapter import EmbeddingIndexAdapter

            return EmbeddingIndexAdapter(inner, self.embedder)
        return inner


class BruteForceKnnFactory(_DeviceKnnFactory):
    """Single-device exact KNN (reference BruteForceKnn,
    nearest_neighbors.py:170)."""


class TpuKnnFactory(_DeviceKnnFactory):
    """Mesh-sharded exact KNN: rows over the "data" axis, per-shard top-k
    and a merge on the first shard's device."""

    sharded = True


class UsearchKnnFactory(TpuKnnFactory):
    """Reference-name compatibility: the reference's approximate HNSW slot
    (nearest_neighbors.py:65) — the exact sharded index serves it, as in
    the reference package."""


class IvfKnnFactory(_DeviceKnnFactory):
    """Approximate IVF index (the reference's usearch-HNSW capability slot;
    ops/ivf.py).  Use for corpora where exact scoring exceeds the latency
    budget (>~1M rows on one card)."""

    def __init__(self, *args, n_clusters=None, n_probe=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_clusters = n_clusters
        self.n_probe = n_probe

    def build_inner_index(self, dimension: Optional[int] = None):
        dim = dimension or self.dimension
        if dim is None:
            raise ValueError("index factory needs the embedding dimension")
        inner = DeviceIvfKnn(
            dimension=dim,
            metric=self.metric,
            n_clusters=self.n_clusters,
            n_probe=self.n_probe,
            device=self.device,
        )
        if self.embedder is not None:
            from .embedding_adapter import EmbeddingIndexAdapter

            return EmbeddingIndexAdapter(inner, self.embedder)
        return inner


class DeviceLshKnn(DeviceKnn):
    """LSH KNN (random-projection buckets on the host, exact rescore of a
    query's candidates on the device) behind the InnerIndexImpl protocol
    (stdlib/ml/_knn_lsh.py)."""

    def __init__(
        self,
        dimension: int,
        metric: str = "cos",
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        device=None,
    ):
        from ..ml._knn_lsh import LshKnnIndex

        self.index = LshKnnIndex(
            dimension=dimension,
            metric=metric,
            n_or=n_or,
            n_and=n_and,
            bucket_length=bucket_length,
            device=device,
        )
        self.metadata: Dict[int, Any] = {}


class LshKnnFactory(_DeviceKnnFactory):
    """The reference's legacy LSH index (_knn_lsh.py:50-94), as a real
    random-projection implementation — not an exact-index alias."""

    def __init__(
        self, *args, n_or: int = 20, n_and: int = 10,
        bucket_length: float = 10.0, **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.n_or = n_or
        self.n_and = n_and
        self.bucket_length = bucket_length

    def build_inner_index(self, dimension: Optional[int] = None):
        dim = dimension or self.dimension
        if dim is None:
            raise ValueError("index factory needs the embedding dimension")
        inner = DeviceLshKnn(
            dimension=dim,
            metric=self.metric,
            n_or=self.n_or,
            n_and=self.n_and,
            bucket_length=self.bucket_length,
            device=self.device,
        )
        if self.embedder is not None:
            from .embedding_adapter import EmbeddingIndexAdapter

            return EmbeddingIndexAdapter(inner, self.embedder)
        return inner


# class-style aliases used by reference code/configs
BruteForceKnn = BruteForceKnnFactory
IvfKnn = IvfKnnFactory
TpuKnn = TpuKnnFactory
USearchKnn = UsearchKnnFactory
LshKnn = LshKnnFactory
