"""Hybrid retrieval: fuse rankings from several indexes with Reciprocal Rank
Fusion (counterpart of ``pathway_tpu/stdlib/indexing/hybrid_index.py``;
reference: stdlib/indexing/hybrid_index.py:14 HybridIndex).  Each
sub-index is searched at ``2k``; a key's fused score is the sum of
``1 / (k_constant + rank + 1)`` over the sub-indexes that return it, and
ties are ordered by ``(-score, key)``.  A device sub-index (``IvfKnn``,
``BruteForceKnn``) runs where its factory's ``device`` says."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .nearest_neighbors import InnerIndexImpl

__all__ = ["HybridIndex", "HybridIndexFactory"]


class HybridIndexImpl(InnerIndexImpl):
    def __init__(self, inner_indexes: Sequence[InnerIndexImpl], k_constant: float = 60.0):
        self.indexes = list(inner_indexes)
        self.k_constant = k_constant

    def add(self, keys, values, metadatas) -> None:
        # values is a tuple-per-row: one value per sub-index (e.g. (vector, text))
        for i, index in enumerate(self.indexes):
            index.add(keys, [v[i] for v in values], metadatas)

    def remove(self, keys) -> None:
        for index in self.indexes:
            index.remove(keys)

    def search(self, values, k, filters):
        per_index = [
            index.search([v[i] for v in values], k * 2, filters)
            for i, index in enumerate(self.indexes)
        ]
        out = []
        for qi in range(len(values)):
            fused: Dict[int, float] = {}
            for index_results in per_index:
                for rank, (key, _score) in enumerate(index_results[qi]):
                    fused[key] = fused.get(key, 0.0) + 1.0 / (
                        self.k_constant + rank + 1
                    )
            ranked = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
            out.append(tuple(ranked))
        return out


class HybridIndexFactory:
    """(reference: HybridIndexFactory, hybrid_index.py)"""

    def __init__(self, retriever_factories: Sequence, k: float = 60.0, **kwargs):
        self.retriever_factories = list(retriever_factories)
        self.k = k

    def build_inner_index(self, dimension: Optional[int] = None) -> HybridIndexImpl:
        return HybridIndexImpl(
            [f.build_inner_index(dimension) for f in self.retriever_factories],
            k_constant=self.k,
        )


HybridIndex = HybridIndexFactory
