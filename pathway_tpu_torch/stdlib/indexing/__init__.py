"""pw.indexing of the port — DataIndex over the device-resident retrieval
indexes (counterpart of ``pathway_tpu/stdlib/indexing``; reference:
python/pathway/stdlib/indexing/ — data_index.py:278, nearest_neighbors.py,
bm25.py, hybrid_index.py).

Ported: ``DataIndex``/``InnerIndex``, the KNN factories (exact, IVF, LSH),
BM25, the hybrid index (reciprocal rank fusion), the retriever surface,
the document-index helpers and ``sorting`` (prev / next retrieval over
``Table.sort``, run inside ``pw.iterate``)."""

from __future__ import annotations

from . import sorting
from .bm25 import BM25Index, TantivyBM25, TantivyBM25Factory
from .data_index import DataIndex, InnerIndex
from .hybrid_index import HybridIndex, HybridIndexFactory
from .nearest_neighbors import (
    BruteForceKnn,
    BruteForceKnnFactory,
    IvfKnn,
    IvfKnnFactory,
    LshKnn,
    LshKnnFactory,
    TpuKnn,
    TpuKnnFactory,
    USearchKnn,
    UsearchKnnFactory,
)
from .retrievers import AbstractRetrieverFactory, BruteForceKnnMetricKind, USearchMetricKind
from .vector_document_index import (
    default_brute_force_knn_document_index,
    default_lsh_knn_document_index,
    default_usearch_knn_document_index,
    default_vector_document_index,
)

__all__ = [
    "DataIndex",
    "InnerIndex",
    "BruteForceKnn",
    "BruteForceKnnFactory",
    "TpuKnn",
    "TpuKnnFactory",
    "USearchKnn",
    "UsearchKnnFactory",
    "IvfKnn",
    "IvfKnnFactory",
    "LshKnn",
    "LshKnnFactory",
    "TantivyBM25",
    "TantivyBM25Factory",
    "BM25Index",
    "HybridIndex",
    "HybridIndexFactory",
    "AbstractRetrieverFactory",
    "BruteForceKnnMetricKind",
    "USearchMetricKind",
    "default_vector_document_index",
    "default_brute_force_knn_document_index",
    "default_usearch_knn_document_index",
    "default_lsh_knn_document_index",
    "sorting",
]
