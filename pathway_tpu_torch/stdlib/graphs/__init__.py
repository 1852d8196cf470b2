"""pw.graphs of the port (counterpart of ``pathway_tpu/stdlib/graphs``;
reference: python/pathway/stdlib/graphs/ — louvain communities,
bellman-ford, pagerank, Graph/WeightedGraph contraction)."""

from __future__ import annotations

from ...internals import api_reducers as reducers
from ...internals.table import Table
from ...internals.thisclass import this
from . import bellman_ford as bellman_ford_mod
from . import louvain_communities
from . import pagerank as pagerank_mod
from .bellman_ford import bellman_ford
from .common import Cluster, Clustering, Edge, Vertex, Weight
from .graph import Graph, WeightedGraph
from .pagerank import pagerank

__all__ = [
    "Graph",
    "WeightedGraph",
    "Vertex",
    "Edge",
    "Weight",
    "Cluster",
    "Clustering",
    "bellman_ford",
    "pagerank",
    "louvain_communities",
    "degrees",
    "in_degrees",
    "out_degrees",
]


def out_degrees(edges: Table) -> Table:
    return edges.groupby(edges.u).reduce(u=this.u, degree=reducers.count())


def in_degrees(edges: Table) -> Table:
    return edges.groupby(edges.v).reduce(v=this.v, degree=reducers.count())


def degrees(edges: Table) -> Table:
    sym = edges.select(a=this.u).concat_reindex(edges.select(a=this.v))
    return sym.groupby(sym.a).reduce(a=this.a, degree=reducers.count())
