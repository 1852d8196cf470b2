"""Default document-index builders of the port (counterpart of
``pathway_tpu/stdlib/indexing/vector_document_index.py``; reference:
stdlib/indexing/vector_document_index.py:34-154 — default_*_document_index
helpers wiring an embedder + a KNN factory into a DataIndex over
(data_column, metadata_column)).  ``device`` (among the keyword
arguments) reaches the factory, so the index is built where the caller
says."""

from __future__ import annotations

from typing import Optional

from ...internals.expression import ColumnReference
from ...internals.table import Table
from .data_index import DataIndex, InnerIndex
from .nearest_neighbors import (
    BruteForceKnnFactory,
    LshKnnFactory,
    TpuKnnFactory,
    UsearchKnnFactory,
)

__all__ = [
    "default_vector_document_index",
    "default_brute_force_knn_document_index",
    "default_usearch_knn_document_index",
    "default_lsh_knn_document_index",
]


def _make(
    factory_cls,
    data_column: ColumnReference,
    data_table: Table,
    *,
    dimensions: Optional[int] = None,
    embedder=None,
    metadata_column: Optional[ColumnReference] = None,
    **kwargs,
) -> DataIndex:
    if embedder is not None and dimensions is None:
        dimensions = embedder.get_embedding_dimension()
    factory = factory_cls(dimension=dimensions, embedder=embedder, **kwargs)
    inner = InnerIndex(
        data_column=data_column,
        metadata_column=metadata_column,
        factory=factory,
        dimension=dimensions,
    )
    return DataIndex(data_table, inner)


def default_vector_document_index(
    data_column: ColumnReference, data_table: Table, **kwargs
) -> DataIndex:
    return _make(TpuKnnFactory, data_column, data_table, **kwargs)


def default_brute_force_knn_document_index(
    data_column: ColumnReference, data_table: Table, **kwargs
) -> DataIndex:
    return _make(BruteForceKnnFactory, data_column, data_table, **kwargs)


def default_usearch_knn_document_index(
    data_column: ColumnReference, data_table: Table, **kwargs
) -> DataIndex:
    return _make(UsearchKnnFactory, data_column, data_table, **kwargs)


def default_lsh_knn_document_index(
    data_column: ColumnReference, data_table: Table, **kwargs
) -> DataIndex:
    return _make(LshKnnFactory, data_column, data_table, **kwargs)
