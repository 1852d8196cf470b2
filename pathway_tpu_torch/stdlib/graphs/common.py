"""Shared graph schemas (counterpart of
``pathway_tpu/stdlib/graphs/common.py``; reference: python/pathway/stdlib/graphs/common.py:10-38 — Vertex, Edge,
Weight, Cluster, Clustering).

Vertices are rows of a vertex table; edges carry ``u``/``v`` pointer columns
(row keys of the vertex table, i.e. ``table.pointer_from(...)`` values).
"""

from __future__ import annotations

from ...internals.keys import Pointer
from ...internals.schema import Schema

__all__ = ["Vertex", "Edge", "Weight", "Cluster", "Clustering"]


class Vertex(Schema):
    pass


class Edge(Schema):
    u: Pointer
    v: Pointer


class Weight(Schema):
    weight: float


class Cluster(Schema):
    pass


class Clustering(Schema):
    c: Pointer
