"""pw.stdlib of the port (counterpart of ``pathway_tpu/stdlib``): ``indexing``
(sorting included), ``ml`` (``KNNIndex``, the LSH index, the KNN
classifier, the fuzzy joins, the HMM reducer), ``stateful``, ``temporal``,
``ordered``, ``statistical``, ``graphs``, ``utils`` (``AsyncTransformer``,
``pandas_transformer``, ``col``) and ``viz``."""

from . import graphs, indexing, ml, ordered, stateful, statistical, temporal, utils, viz

__all__ = ["graphs", "indexing", "ml", "ordered", "stateful", "statistical", "temporal", "utils", "viz"]
