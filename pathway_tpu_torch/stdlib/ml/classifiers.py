"""KNN classifiers of the port (counterpart of
``pathway_tpu/stdlib/ml/classifiers.py``; reference:
stdlib/ml/classifiers.py + _knn_lsh.py:64 knn_lsh_classifier_train —
label voting over retrieved neighbours)."""

from __future__ import annotations

from collections import Counter

from ...internals import dtype as dt
from ...internals.expression import ApplyExpression, ColumnReference
from ...internals.table import Table
from .index import KNNIndex

__all__ = ["knn_classifier"]


def knn_classifier(
    data_embedding: ColumnReference,
    data: Table,
    label_column: ColumnReference,
    query_embedding: ColumnReference,
    n_dimensions: int,
    k: int = 3,
    device=None,
) -> Table:
    """Majority-vote label from the k nearest neighbours of each query
    (the index on ``device``, the CUDA device unless ``"cpu"``)."""
    index = KNNIndex(data_embedding, data, n_dimensions=n_dimensions, device=device)
    result = index._index.query(
        query_embedding, number_of_matches=k, collapse_rows=True
    )
    labels = result.select(_pw_labels=label_column)

    def vote(ls):
        ls = [l for l in ls if l is not None]
        if not ls:
            return None
        return Counter(ls).most_common(1)[0][0]

    from ...internals.thisclass import this

    return labels.select(
        predicted_label=ApplyExpression(vote, dt.ANY, args=(this._pw_labels,))
    )
