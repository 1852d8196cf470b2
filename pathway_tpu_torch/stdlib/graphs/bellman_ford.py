"""Bellman–Ford single-source shortest paths, iterated to fixed point
(counterpart of ``pathway_tpu/stdlib/graphs/bellman_ford.py``; reference: python/pathway/stdlib/graphs/bellman_ford/impl.py:26-51 —
edge relaxation inside ``pw.iterate``).

``vertices`` must have a bool ``is_source`` column; ``edges`` carry
``u``/``v`` vertex pointers and a float ``dist`` column.  Returns a table
keyed like ``vertices`` with ``dist_from_source`` (``inf`` if unreachable).
"""

from __future__ import annotations

import math

from ...internals import api_reducers as reducers
from ...internals.expression import ApplyExpression, IfElseExpression
from ...internals.iterate import iterate
from ...internals.table import Table
from ...internals.thisclass import this

__all__ = ["bellman_ford"]


def _relax(vertices_dist: Table, base: Table, edges: Table) -> Table:
    relaxed = edges.select(
        v=this.v,
        cand=vertices_dist.ix(edges.u).dist_from_source + edges.dist,
    )
    best = relaxed.groupby(id=this.v).reduce(cand=reducers.min(this.cand))
    joined = base.join_left(best, base.id == best.id)
    return joined.select(
        dist_from_source=ApplyExpression(
            lambda b, c: b if c is None or b <= c else c,
            None,
            args=(base.dist_from_source, best.cand),
        )
    )


def bellman_ford(vertices: Table, edges: Table) -> Table:
    initial = vertices.select(
        dist_from_source=IfElseExpression(this.is_source, 0.0, math.inf)
    )
    return iterate(
        lambda vertices_dist, base, edges: _relax(vertices_dist, base, edges),
        vertices_dist=initial,
        base=initial,
        edges=edges,
    )
