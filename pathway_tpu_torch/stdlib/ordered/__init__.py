"""pw.ordered of the port — diff over a sort key (counterpart of
``pathway_tpu/stdlib/ordered``; reference: python/pathway/stdlib/ordered/diff.py:10)."""

from __future__ import annotations

from ...internals import api_reducers as reducers
from ...internals import dtype as dt
from ...internals.expression import ApplyExpression
from ...internals.table import Table
from ...internals.thisclass import this

__all__ = ["diff"]


def diff(table: Table, timestamp, *values, instance=None) -> Table:
    """Difference of each value column vs. the previous row in timestamp order."""
    names = [v.name for v in values]
    packed = table.groupby(*([] if instance is None else [instance])).reduce(
        _pw_rows=reducers.sorted_tuple(
            ApplyExpression(
                lambda t, *vals: (t, vals),
                dt.ANY,
                args=(timestamp, *values),
            )
        )
    )

    def diffs(rows):
        out = []
        prev = None
        for t, vals in rows:
            if prev is None:
                out.append((t, tuple(None for _ in vals)))
            else:
                out.append((t, tuple(v - p for v, p in zip(vals, prev))))
            prev = vals
        return out

    exploded = packed.select(
        _pw_diffs=ApplyExpression(diffs, dt.ANY, args=(packed._pw_rows,))
    ).flatten(this._pw_diffs)
    result = exploded.select(
        timestamp=ApplyExpression(lambda d: d[0], dt.ANY, args=(this._pw_diffs,)),
        **{
            f"diff_{name}": ApplyExpression(
                lambda d, _i=i: d[1][_i], dt.ANY, args=(this._pw_diffs,)
            )
            for i, name in enumerate(names)
        },
    )
    return result
