"""pw.ml of the port (counterpart of ``pathway_tpu/stdlib/ml``; reference:
python/pathway/stdlib/ml/ — KNNIndex, LSH, classifiers, smart_table_ops
fuzzy joins).

Ported: ``KNNIndex`` (``index.py``), ``knn_classifier``
(``classifiers.py``) and the LSH index (``_knn_lsh.py``, behind
``pw.indexing.LshKnnFactory``).  The HMM reducer and the fuzzy joins
(``hmm.py``, ``smart_table_ops.py``) come with the rest of ``stdlib``:
their names raise ``NotImplementedError`` naming the slice."""

from __future__ import annotations

from . import classifiers, index
from ...internals.unported import LaterSliceModule as _StubModule
from ...internals.unported import later_slice as _stub
from .classifiers import knn_classifier
from .index import KNNIndex


def _later_slice(name: str, what: str):
    return _stub(f"ml.{name}", "3b", what)


hmm = _StubModule("ml.hmm", "3b", "stdlib/ml/hmm.py")
smart_table_ops = _StubModule("ml.smart_table_ops", "3b", "stdlib/ml/smart_table_ops.py")
create_hmm_reducer = _later_slice("create_hmm_reducer", "stdlib/ml/hmm.py")
FuzzyJoinFeatureGeneration = _later_slice("FuzzyJoinFeatureGeneration", "stdlib/ml/smart_table_ops.py")
FuzzyJoinNormalization = _later_slice("FuzzyJoinNormalization", "stdlib/ml/smart_table_ops.py")
fuzzy_match = _later_slice("fuzzy_match", "stdlib/ml/smart_table_ops.py")
fuzzy_match_tables = _later_slice("fuzzy_match_tables", "stdlib/ml/smart_table_ops.py")
fuzzy_self_match = _later_slice("fuzzy_self_match", "stdlib/ml/smart_table_ops.py")
smart_fuzzy_match = _later_slice("smart_fuzzy_match", "stdlib/ml/smart_table_ops.py")

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
