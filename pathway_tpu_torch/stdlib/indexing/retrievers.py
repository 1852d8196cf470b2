"""Retriever factory surface of the port (counterpart of
``pathway_tpu/stdlib/indexing/retrievers.py``; reference:
stdlib/indexing/retrievers.py — AbstractRetrieverFactory and metric kinds
used by DocumentStore configs)."""

from __future__ import annotations

import enum

from .bm25 import TantivyBM25Factory
from .hybrid_index import HybridIndexFactory
from .nearest_neighbors import (
    BruteForceKnnFactory,
    LshKnnFactory,
    TpuKnnFactory,
    UsearchKnnFactory,
)

__all__ = [
    "AbstractRetrieverFactory",
    "BruteForceKnnMetricKind",
    "USearchMetricKind",
    "BruteForceKnnFactory",
    "TpuKnnFactory",
    "UsearchKnnFactory",
    "LshKnnFactory",
    "TantivyBM25Factory",
    "HybridIndexFactory",
]


class AbstractRetrieverFactory:
    def build_inner_index(self, dimension=None):
        raise NotImplementedError


class BruteForceKnnMetricKind(enum.Enum):
    """(reference: BruteForceKnnMetricKind, engine.pyi:869)"""

    COS = "cos"
    L2SQ = "l2sq"


class USearchMetricKind(enum.Enum):
    """(reference: USearchMetricKind, engine.pyi:854)"""

    COS = "cos"
    L2SQ = "l2sq"
    IP = "dot"
