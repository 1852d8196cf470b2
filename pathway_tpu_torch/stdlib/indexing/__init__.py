"""pw.indexing of the port — DataIndex over the device-resident retrieval
indexes (counterpart of ``pathway_tpu/stdlib/indexing``; reference:
python/pathway/stdlib/indexing/ — data_index.py:278, nearest_neighbors.py).

Ported: ``DataIndex``/``InnerIndex`` and the KNN factories.  BM25, the
hybrid index, the document-index helpers and sorting come with the rest
of ``stdlib``, a later slice (``ROADMAP.md``)."""

from __future__ import annotations

from .data_index import DataIndex, InnerIndex
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
]
