"""Graph / WeightedGraph containers with cluster contraction
(counterpart of ``pathway_tpu/stdlib/graphs/graph.py``; reference: python/pathway/stdlib/graphs/graph.py:13-150 — _contract,
_contract_weighted, Graph.contracted_to_*, without_self_loops).

A clustering is a table keyed by vertex with a ``c`` column (the cluster the
vertex belongs to, itself a pointer).  Contraction relabels edge endpoints by
their clusters and merges parallel edges (summing weights for weighted
graphs).
"""

from __future__ import annotations

from dataclasses import dataclass

from ...internals import api_reducers as reducers
from ...internals.table import Table
from ...internals.thisclass import this

__all__ = ["Graph", "WeightedGraph"]


@dataclass
class Graph:
    """A directed (multi)graph as a vertex table + edge table (u, v pointers)."""

    V: Table
    E: Table

    def without_self_loops(self) -> "Graph":
        return Graph(self.V, self.E.filter(this.u != this.v))

    def _relabeled_edges(self, clustering: Table) -> Table:
        """Edge endpoints replaced by their clusters."""
        return self.E.select(
            u=clustering.ix(self.E.u).c,
            v=clustering.ix(self.E.v).c,
        )

    def contracted_to_multi_graph(self, clustering: Table) -> "Graph":
        edges = self._relabeled_edges(clustering)
        vertices = clustering.groupby(id=this.c).reduce(cnt=reducers.count())
        return Graph(vertices, edges)

    def contracted_to_unweighted_simple_graph(self, clustering: Table) -> "Graph":
        edges = self._relabeled_edges(clustering)
        simple = edges.groupby(id=edges.pointer_from(this.u, this.v)).reduce(
            u=reducers.any(this.u), v=reducers.any(this.v)
        )
        vertices = clustering.groupby(id=this.c).reduce(cnt=reducers.count())
        return Graph(vertices, simple)

    def contracted_to_weighted_simple_graph(
        self, clustering: Table
    ) -> "WeightedGraph":
        """Parallel edges merge; each original edge contributes weight 1."""
        edges = self._relabeled_edges(clustering)
        weighted = edges.groupby(id=edges.pointer_from(this.u, this.v)).reduce(
            u=reducers.any(this.u),
            v=reducers.any(this.v),
            weight=reducers.count(),
        )
        vertices = clustering.groupby(id=this.c).reduce(cnt=reducers.count())
        return WeightedGraph(vertices, weighted)


@dataclass
class WeightedGraph(Graph):
    """Graph whose edges carry a ``weight`` column."""

    @staticmethod
    def from_vertices_and_weighted_edges(V: Table, WE: Table) -> "WeightedGraph":
        return WeightedGraph(V, WE)

    def without_self_loops(self) -> "WeightedGraph":
        return WeightedGraph(self.V, self.E.filter(this.u != this.v))

    def contracted_to_weighted_simple_graph(
        self, clustering: Table
    ) -> "WeightedGraph":
        edges = self.E.select(
            u=clustering.ix(self.E.u).c,
            v=clustering.ix(self.E.v).c,
            weight=this.weight,
        )
        merged = edges.groupby(id=edges.pointer_from(this.u, this.v)).reduce(
            u=reducers.any(this.u),
            v=reducers.any(this.v),
            weight=reducers.sum(this.weight),
        )
        vertices = clustering.groupby(id=this.c).reduce(cnt=reducers.count())
        return WeightedGraph(vertices, merged)
