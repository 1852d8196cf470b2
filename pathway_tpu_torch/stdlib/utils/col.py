"""Column utilities of the port (counterpart of
``pathway_tpu/stdlib/utils/col.py``; reference: python/pathway/stdlib/utils/col.py:367)."""

from __future__ import annotations

from typing import Callable, Optional

from ...internals import dtype as dt
from ...internals.expression import ApplyExpression, ColumnReference
from ...internals.table import Table

__all__ = ["unpack_col", "multiapply_all_rows", "apply_all_rows", "flatten_column"]


def unpack_col(column: ColumnReference, *unpacked_columns, schema=None) -> Table:
    """Unpack a tuple column into named columns."""
    table = column.table
    if schema is not None:
        names = list(schema.columns().keys())
    else:
        names = [
            c.name if isinstance(c, ColumnReference) else str(c)
            for c in unpacked_columns
        ]
    return table.select(
        **{
            name: ApplyExpression(
                lambda v, _i=i: v[_i] if v is not None else None,
                dt.ANY,
                args=(column,),
            )
            for i, name in enumerate(names)
        }
    )


def apply_all_rows(
    *cols: ColumnReference,
    fun: Callable,
    result_col_name: str,
) -> Table:
    """Apply ``fun`` to entire columns at once (lists of all rows) — the
    batched escape hatch (reference: col.py apply_all_rows)."""
    table = cols[0].table
    return table.select(
        **{
            result_col_name: ApplyExpression(
                lambda *arrays: fun(*[list(a) for a in arrays]),
                dt.ANY,
                args=cols,
                batched=True,
            )
        }
    )


multiapply_all_rows = apply_all_rows


def flatten_column(column: ColumnReference, origin_id: Optional[str] = None) -> Table:
    if origin_id is not None:
        # the reference drops it: its rows carry no origin column
        raise NotImplementedError(f"flatten_column(origin_id={origin_id!r}) is not supported (the reference ignores it)")
    table = column.table
    return table.flatten(column)
