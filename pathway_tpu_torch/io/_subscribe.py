"""pw.io.subscribe — per-row change callbacks
(reference: python/pathway/io/_subscribe.py)."""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..engine.graph import OutputCallbacks
from ..engine.operators.io import SubscribeOperator
from ..internals.keys import Pointer
from ..internals.parse_graph import G
from ..internals.table import Table

__all__ = ["subscribe"]


def subscribe(
    table: Table,
    on_change: Callable[..., None],
    on_end: Optional[Callable[[], None]] = None,
    on_time_end: Optional[Callable[[int], None]] = None,
) -> None:
    """on_change(key, row: dict, time: int, is_addition: bool)."""
    names = table.column_names
    engine_names = [table._column_mapping[n] for n in names]
    engine_table = table._engine_table
    col_idx = [engine_table.column_names.index(e) for e in engine_names]

    wrapped = None
    if on_change is not None:

        def wrapped(key, row_tuple, time, diff):
            row = {n: row_tuple[i] for n, i in zip(names, col_idx)}
            on_change(key=Pointer(key), row=row, time=time, is_addition=diff > 0)

    op = SubscribeOperator(
        engine_table,
        OutputCallbacks(
            on_change=wrapped, on_time_end=on_time_end, on_end=on_end
        ),
        name="subscribe",
    )
    G.engine_graph.add_operator(op)
