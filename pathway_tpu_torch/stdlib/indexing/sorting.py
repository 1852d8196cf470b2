"""Sorted-structure API of the port (counterpart of
``pathway_tpu/stdlib/indexing/sorting.py``; reference:
stdlib/indexing/sorting.py:230 —
binsearch trees + prev/next retrieval over sorted tables).

The reference builds a randomized binsearch tree with ``pw.iterate`` and
derives prev/next pointers from tree traversal (sort_from_index); here
``Table.sort`` computes prev/next directly in the engine
(engine/operators/sort.py), and this module supplies the value-walking API
on top plus host-side binsearch helpers used by the asof machinery."""

from __future__ import annotations

import bisect
from typing import Any, List, Tuple

__all__ = [
    "binsearch_lower",
    "binsearch_upper",
    "sort_from_index",
    "retrieve_prev_next_values",
]


def binsearch_lower(sorted_pairs: List[Tuple[Any, Any]], key: Any):
    """Largest entry with k <= key (None if none)."""
    keys = [k for k, _ in sorted_pairs]
    i = bisect.bisect_right(keys, key) - 1
    return sorted_pairs[i][1] if i >= 0 else None


def binsearch_upper(sorted_pairs: List[Tuple[Any, Any]], key: Any):
    """Smallest entry with k >= key (None if none)."""
    keys = [k for k, _ in sorted_pairs]
    i = bisect.bisect_left(keys, key)
    return sorted_pairs[i][1] if i < len(sorted_pairs) else None


def sort_from_index(table, key, instance=None):
    """prev/next pointer columns for ``table`` in ``key`` order — the
    reference's tree-derived API (sorting.py:137), served by the engine sort
    operator here."""
    return table.sort(key, instance=instance)


def retrieve_prev_next_values(ordered_table, value=None):
    """For each row of a prev/next-ordered table, pointers-walk to the
    nearest row (itself included) with a non-None ``value`` in each
    direction; returns columns ``prev_value`` / ``next_value``
    (reference: sorting.py:195 — same iterate-to-fixpoint shape)."""
    from ...internals.expression import CoalesceExpression, RequireExpression
    from ...internals.iterate import iterate
    from ...internals.thisclass import this

    if value is None:
        value = ordered_table.value
    elif isinstance(value, str):
        value = getattr(ordered_table, value)

    seeded = ordered_table.select(
        prev=ordered_table.prev,
        next=ordered_table.next,
        value=value,
    )
    seeded = seeded.with_columns(
        prev_value=RequireExpression(this.id, this.value),
        next_value=RequireExpression(this.id, this.value),
    )

    def walk(tab):
        return tab.with_columns(
            prev_value=CoalesceExpression(
                tab.prev_value,
                tab.ix(tab.prev, optional=True).prev_value,
            ),
            next_value=CoalesceExpression(
                tab.next_value,
                tab.ix(tab.next, optional=True).next_value,
            ),
        )

    result = iterate(walk, tab=seeded)
    return result.select(result.prev_value, result.next_value)
