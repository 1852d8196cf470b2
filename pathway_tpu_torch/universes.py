"""pw.universes — universe promises
(reference: python/pathway/internals/universes.py)."""

from __future__ import annotations

from .internals.table import Table

__all__ = ["promise_are_equal", "promise_are_pairwise_disjoint", "promise_is_subset_of"]


def promise_are_equal(*tables: Table) -> None:
    for t in tables[1:]:
        tables[0]._universe.promise_equal(t._universe)


def promise_is_subset_of(subset: Table, superset: Table) -> None:
    subset._universe.promise_subset_of(superset._universe)


def promise_are_pairwise_disjoint(*tables: Table) -> None:
    """Vouch the tables' key sets never intersect: ``concat`` built after
    this promise skips its runtime collision check (without a promise,
    collisions raise — reference: universes.py + the static universe
    solver)."""
    for i, a in enumerate(tables):
        for b in tables[i + 1 :]:
            a._universe.promise_disjoint(b._universe)
