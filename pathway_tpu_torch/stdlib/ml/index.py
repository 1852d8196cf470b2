"""Legacy KNNIndex API of the port (counterpart of
``pathway_tpu/stdlib/ml/index.py``; reference: stdlib/ml/index.py:9 —
KNNIndex with get_nearest_items / get_nearest_items_asof_now over the LSH
dataflow implementation _knn_lsh.py).  Here it wraps a DataIndex over
``TpuKnnFactory``'s exact device index, on the CUDA device unless
``device="cpu"`` is passed."""

from __future__ import annotations

from typing import Optional

from ...internals.expression import ColumnReference
from ...internals.table import Table
from ..indexing.data_index import DataIndex, InnerIndex
from ..indexing.nearest_neighbors import TpuKnnFactory

__all__ = ["KNNIndex"]


class KNNIndex:
    """K-nearest-neighbours over an embedding column of a live table."""

    def __init__(
        self,
        data_embedding: ColumnReference,
        data: Table,
        n_dimensions: int,
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        distance_type: str = "euclidean",
        metadata: Optional[ColumnReference] = None,
        device=None,
    ):
        metric = "l2sq" if distance_type == "euclidean" else "cos"
        self._metric = metric
        factory = TpuKnnFactory(
            dimension=n_dimensions, metric=metric, reserved_space=1024, device=device
        )
        self._index = DataIndex(
            data,
            InnerIndex(
                data_column=data_embedding,
                metadata_column=metadata,
                factory=factory,
                dimension=n_dimensions,
            ),
        )
        self._data = data

    def get_nearest_items(
        self,
        query_embedding: ColumnReference,
        k: int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter=None,
    ):
        result = self._index.query(
            query_embedding,
            number_of_matches=k,
            collapse_rows=collapse_rows,
            metadata_filter=metadata_filter,
        )
        return self._project(result, collapse_rows, with_distances)

    def get_nearest_items_asof_now(
        self,
        query_embedding: ColumnReference,
        k: int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter=None,
    ):
        result = self._index.query_as_of_now(
            query_embedding,
            number_of_matches=k,
            collapse_rows=collapse_rows,
            metadata_filter=metadata_filter,
        )
        return self._project(result, collapse_rows, with_distances)

    def _project(self, result, collapse_rows: bool, with_distances: bool) -> Table:
        cols = {
            name: ColumnReference(self._data, name)
            for name in self._data.column_names
        }
        out = result.select(
            **cols, **({"dist": result.score} if with_distances else {})
        )
        if with_distances:
            # ranking scores -> distances (ascending = closer), matching the
            # reference's dist column: cos -> 1 - sim; l2sq ranking score is
            # 2q.x - ||x||^2 which is monotone-decreasing in distance -> negate
            metric = self._metric
            from ...internals import dtype as dt_mod
            from ...internals.expression import ApplyExpression
            from ...internals.thisclass import this

            def to_dist(scores):
                if scores is None:
                    return scores
                if isinstance(scores, tuple):
                    return tuple(
                        (1.0 - s) if metric == "cos" else -s for s in scores
                    )
                return (1.0 - scores) if metric == "cos" else -scores

            out = out.with_columns(
                dist=ApplyExpression(to_dist, dt_mod.ANY, args=(this.dist,))
            )
        return out
