"""Universes — key-set identity of tables
(reference: python/pathway/internals/universe.py + universe_solver.py).

Tables sharing a universe have identical key sets; operations check
universe compatibility before zipping columns.  Relations (parentage,
promises) register with the static solver (internals/universe_solver.py),
so subset/equality/disjointness queries are transitive PROOFS at graph
build time — the reference's SAT-backed behavior — and provably-invalid
operations (``update_cells`` across unrelated universes) raise at
construction, not at tick time."""

from __future__ import annotations

import itertools
from typing import Optional, Set

from .universe_solver import get_solver

__all__ = ["Universe"]


class Universe:
    _ids = itertools.count()

    def __init__(self, parent: Optional["Universe"] = None):
        self.id = next(Universe._ids)
        self.parent = parent
        if parent is not None:
            get_solver().register_subset(self.id, parent.id)
        # kept for cheap promise bookkeeping alongside the solver
        self._equal: Set[int] = {self.id}
        self._disjoint: Set[int] = set()

    def subuniverse(self) -> "Universe":
        return Universe(parent=self)

    def is_subset_of(self, other: "Universe") -> bool:
        return self.id == other.id or get_solver().query_is_subset(
            self.id, other.id
        )

    def is_equal_to(self, other: "Universe") -> bool:
        return bool(self._equal & other._equal) or get_solver().query_are_equal(
            self.id, other.id
        )

    def promise_equal(self, other: "Universe") -> None:
        merged = self._equal | other._equal
        self._equal = merged
        other._equal = merged
        get_solver().register_equal(self.id, other.id)

    def promise_subset_of(self, other: "Universe") -> None:
        get_solver().register_subset(self.id, other.id)

    def promise_disjoint(self, other: "Universe") -> None:
        """User vouches the two key sets never intersect (reference
        promise_are_pairwise_disjoint) — concat then skips its runtime
        collision check."""
        self._disjoint.update(other._equal)
        other._disjoint.update(self._equal)
        get_solver().register_disjoint(self.id, other.id)

    def is_promised_disjoint(self, other: "Universe") -> bool:
        return (
            bool(self._disjoint & other._equal)
            or bool(other._disjoint & self._equal)
            or get_solver().query_are_disjoint(self.id, other.id)
        )

    def __repr__(self):  # pragma: no cover
        return f"<Universe {self.id}>"
