"""pw.stdlib of the port (counterpart of ``pathway_tpu/stdlib``).

Ported: ``indexing``, ``ml`` (``KNNIndex``, the LSH index, the KNN
classifier; ``hmm`` and ``smart_table_ops`` raise) and ``stateful``.  The
rest (graphs, ordered, statistical, temporal, utils, viz) is a later
slice (``ROADMAP.md``)."""

from . import indexing, ml, stateful

__all__ = ["indexing", "ml", "stateful"]
