"""Sorted prev/next pointers — the engine op behind ``Table.sort``.

The reference computes, for every row, pointers to its predecessor and
successor in key order within an instance, incrementally via a custom timely
operator (src/engine/dataflow/operators/prev_next.rs; surfaced as
``pw.Table.sort``, python/pathway/internals/table.py:2157).  Here the
operator keeps one bisect-sorted order per instance and on each delta
re-links the touched instances, emitting only rows whose (prev, next) pair
actually changed — the incremental output matches a from-scratch sort.
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..delta import Delta
from ..graph import EngineOperator, EngineTable

__all__ = ["SortOperator"]


def _hashable(value: Any) -> Any:
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, (list, np.ndarray)):
        return tuple(value)
    return value


class SortOperator(EngineOperator):
    """Input columns: ``_pw_sort_key`` (orderable) and ``_pw_instance``;
    output columns ``prev``/``next`` (uint64 pointers or None), keyed by the
    input row keys.  Ties order by row key, so the order is deterministic."""

    def __init__(self, input: EngineTable, output: EngineTable, name: str = "sort"):
        super().__init__([input], output, name)
        # instance -> sorted [(sort_key, row_key), ...]
        self._orders: Dict[Any, List[Tuple[Any, int]]] = {}
        # row_key -> (prev_key | None, next_key | None)
        self._links: Dict[int, Tuple[Optional[int], Optional[int]]] = {}

    def snapshot_state(self):
        return {"orders": self._orders, "links": self._links}

    def restore_state(self, state) -> None:
        self._orders = state["orders"]
        self._links = state["links"]

    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        if delta.n == 0:
            return None
        delta = delta.consolidated()
        kcol = list(delta.columns["_pw_sort_key"])
        icol = list(delta.columns["_pw_instance"])
        # neighbour-local incremental maintenance: each mutation touches at
        # most itself and its two adjacent entries, so only those rows are
        # re-linked afterwards — O(batch * log n), never a full-order rescan
        affected: Dict[Any, set] = {}
        removed: List[int] = []
        for key, diff, kv, inst in zip(
            delta.keys.tolist(), delta.diffs.tolist(), kcol, icol
        ):
            inst = _hashable(inst)
            entry = (_hashable(kv), int(key))
            order = self._orders.setdefault(inst, [])
            touched = affected.setdefault(inst, set())
            if diff > 0:
                i = bisect.bisect_left(order, entry)
                order.insert(i, entry)
                touched.add(entry)
                if i > 0:
                    touched.add(order[i - 1])
                if i + 1 < len(order):
                    touched.add(order[i + 1])
            else:
                i = bisect.bisect_left(order, entry)
                if i < len(order) and order[i] == entry:
                    order.pop(i)
                    if i > 0:
                        touched.add(order[i - 1])
                    if i < len(order):
                        touched.add(order[i])
                touched.discard(entry)
                removed.append(int(key))
                if not order:
                    del self._orders[inst]

        rows: List[Tuple[int, int, Tuple[Any, Any]]] = []

        def as_ptr(k: Optional[int]):
            return np.uint64(k) if k is not None else None

        for key in removed:
            old = self._links.pop(key, None)
            if old is not None:
                rows.append((key, -1, (as_ptr(old[0]), as_ptr(old[1]))))
        for inst, touched in affected.items():
            order = self._orders.get(inst, [])
            last = len(order) - 1
            for entry in touched:
                i = bisect.bisect_left(order, entry)
                if i > last or order[i] != entry:
                    continue  # removed later in the same batch
                row_key = entry[1]
                link = (
                    order[i - 1][1] if i > 0 else None,
                    order[i + 1][1] if i < last else None,
                )
                old = self._links.get(row_key)
                if old == link:
                    continue
                if old is not None:
                    rows.append((row_key, -1, (as_ptr(old[0]), as_ptr(old[1]))))
                self._links[row_key] = link
                rows.append((row_key, 1, (as_ptr(link[0]), as_ptr(link[1]))))
        if not rows:
            return None
        return Delta.from_rows(["prev", "next"], rows)
