"""PageRank over a live edge table (counterpart of
``pathway_tpu/stdlib/graphs/pagerank.py``; reference: python/pathway/stdlib/graphs/pagerank/impl.py:18-41 — integer
power iteration unrolled ``steps`` times; this build uses float ranks with
the standard damping formulation, unrolled the same way so each step is an
incremental groupby/join that updates live as edges change).
"""

from __future__ import annotations

from ...internals import api_reducers as reducers
from ...internals.expression import ApplyExpression
from ...internals.table import Table
from ...internals.thisclass import this

__all__ = ["pagerank"]


def pagerank(edges: Table, steps: int = 5, damping: float = 0.85) -> Table:
    """Rank every vertex that appears in ``edges`` (as u or v).

    Returns a table keyed by vertex pointer with a ``rank`` column.
    Dangling vertices (no outgoing edges) leak rank, as in the reference.
    """
    endpoints = edges.select(k=this.u).concat_reindex(edges.select(k=this.v))
    vertices = endpoints.groupby(id=this.k).reduce(cnt=reducers.count())

    out_deg = edges.groupby(id=this.u).reduce(degree=reducers.count())
    joined = vertices.join_left(out_deg, vertices.id == out_deg.id)
    degrees = joined.select(
        degree=ApplyExpression(
            lambda d: int(d) if d is not None else 0,
            None,
            args=(out_deg.degree,),
        )
    )

    ranks = vertices.select(rank=1.0)
    base = 1.0 - damping
    for _ in range(steps):
        contrib = edges.select(
            v=this.v,
            flow=damping
            * ranks.ix(edges.u).rank
            / ApplyExpression(
                lambda d: float(d) if d else 1.0,
                None,
                args=(degrees.ix(edges.u).degree,),
            ),
        )
        inflow = contrib.groupby(id=this.v).reduce(flow=reducers.sum(this.flow))
        rejoined = vertices.join_left(inflow, vertices.id == inflow.id)
        ranks = rejoined.select(
            rank=ApplyExpression(
                lambda f, b=base: b + (float(f) if f is not None else 0.0),
                None,
                args=(inflow.flow,),
            )
        )
    return ranks
