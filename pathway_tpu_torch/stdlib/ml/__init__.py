"""pw.ml of the port (counterpart of ``pathway_tpu/stdlib/ml``; reference:
python/pathway/stdlib/ml/ — KNNIndex, LSH, classifiers, smart_table_ops
fuzzy joins): ``KNNIndex`` (``index.py``), ``knn_classifier``
(``classifiers.py``), the LSH index (``_knn_lsh.py``, behind
``pw.indexing.LshKnnFactory``), the HMM reducer (``hmm.py``) and the fuzzy
joins (``smart_table_ops.py``)."""

from __future__ import annotations

from . import classifiers, hmm, index, smart_table_ops
from .classifiers import knn_classifier
from .hmm import create_hmm_reducer
from .index import KNNIndex
from .smart_table_ops import (
    FuzzyJoinFeatureGeneration,
    FuzzyJoinNormalization,
    fuzzy_match,
    fuzzy_match_tables,
    fuzzy_self_match,
    smart_fuzzy_match,
)

__all__ = [
    "index",
    "KNNIndex",
    "classifiers",
    "knn_classifier",
    "hmm",
    "smart_table_ops",
    "create_hmm_reducer",
    "FuzzyJoinFeatureGeneration",
    "FuzzyJoinNormalization",
    "fuzzy_match",
    "fuzzy_match_tables",
    "fuzzy_self_match",
    "smart_fuzzy_match",
]
