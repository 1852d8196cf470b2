"""Static universe solver — build-time key-set consistency proofs.

The reference proves subset/equality/disjointness relations between table
key sets with a SAT solver over implication clauses
(python/pathway/internals/universe_solver.py: subset(A,B) becomes the
clause ¬A ∨ B on pysat).  Every clause that code base ever emits is a Horn
implication, so the same proofs fall out of plain transitive closure over
an implication graph — no SAT dependency, same answers, and queries stay
O(edges) with memoized closures.

Relations registered at graph build time (Universe construction +
pw.universes promises); queries gate operations like ``update_cells`` so a
provably-inconsistent graph fails at CONSTRUCTION, not at tick time.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Set

__all__ = ["UniverseSolver", "get_solver"]


class UniverseSolver:
    def __init__(self):
        # subset -> supersets (one implication edge per registered relation)
        self._edges: Dict[int, Set[int]] = {}
        self._disjoint: Set[FrozenSet[int]] = set()
        self._closure_cache: Dict[int, FrozenSet[int]] = {}

    # -- registration ------------------------------------------------------
    def register_subset(self, sub: int, sup: int) -> None:
        self._edges.setdefault(sub, set()).add(sup)
        self._closure_cache.clear()

    def register_equal(self, a: int, b: int) -> None:
        self.register_subset(a, b)
        self.register_subset(b, a)

    def register_disjoint(self, a: int, b: int) -> None:
        self._disjoint.add(frozenset((a, b)))

    # -- queries -----------------------------------------------------------
    def supersets(self, u: int) -> FrozenSet[int]:
        """u plus every universe reachable over subset edges."""
        cached = self._closure_cache.get(u)
        if cached is not None:
            return cached
        seen: Set[int] = {u}
        stack = [u]
        while stack:
            for nxt in self._edges.get(stack.pop(), ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        out = frozenset(seen)
        self._closure_cache[u] = out
        return out

    def query_is_subset(self, sub: int, sup: int) -> bool:
        return sup in self.supersets(sub)

    def query_are_equal(self, a: int, b: int) -> bool:
        return self.query_is_subset(a, b) and self.query_is_subset(b, a)

    def query_are_disjoint(self, a: int, b: int) -> bool:
        """Provably disjoint: some registered disjoint pair (X, Y) covers
        them (a ⊆ X and b ⊆ Y, either orientation)."""
        sup_a = self.supersets(a)
        sup_b = self.supersets(b)
        for pair in self._disjoint:
            if len(pair) == 1:
                continue
            x, y = tuple(pair)
            if (x in sup_a and y in sup_b) or (y in sup_a and x in sup_b):
                return True
        return False


    def clear(self) -> None:
        """Forget every relation (pw.reset(): universes die with the graph;
        without this, edges accumulate unboundedly across rebuilds)."""
        self._edges.clear()
        self._disjoint.clear()
        self._closure_cache.clear()


_solver = UniverseSolver()


def get_solver() -> UniverseSolver:
    return _solver
