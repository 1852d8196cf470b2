"""pw.stdlib of the port (counterpart of ``pathway_tpu/stdlib``).

Ported: ``indexing`` (sorting included), ``ml`` (``KNNIndex``, the LSH
index, the KNN classifier; ``hmm`` and ``smart_table_ops`` raise),
``stateful``, ``temporal``, ``ordered``, ``statistical`` and ``graphs``.
Left for a later slice (``ROADMAP.md``, framework slice 3b): ``utils``
(``AsyncTransformer``, ``pandas_transformer``, ``col``) and ``viz``; each
is a stub module whose names raise ``NotImplementedError`` naming the
slice."""

from ..internals.unported import LaterSliceModule as _StubModule
from . import graphs, indexing, ml, ordered, stateful, statistical, temporal

utils = _StubModule("utils", "3b", "stdlib/utils")
viz = _StubModule("viz", "3b", "stdlib/viz")

__all__ = ["graphs", "indexing", "ml", "ordered", "stateful", "statistical", "temporal", "utils", "viz"]
