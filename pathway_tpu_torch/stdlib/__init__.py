"""pw.stdlib of the port (counterpart of ``pathway_tpu/stdlib``).

Ported: ``indexing``.  The rest (graphs, ml, ordered, stateful,
statistical, temporal, utils, viz) is a later slice (``ROADMAP.md``)."""

from . import indexing

__all__ = ["indexing"]
