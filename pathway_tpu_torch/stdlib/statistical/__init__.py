"""pw.statistical of the port (counterpart of
``pathway_tpu/stdlib/statistical``; reference: python/pathway/stdlib/statistical/_interpolate.py)."""

from __future__ import annotations

import enum

from ...internals import api_reducers as reducers
from ...internals import dtype as dt
from ...internals.expression import ApplyExpression
from ...internals.table import Table
from ...internals.thisclass import this

__all__ = ["interpolate", "InterpolateMode"]


class InterpolateMode(enum.Enum):
    LINEAR = "linear"


def interpolate(
    table: Table, timestamp, *values, mode: InterpolateMode = InterpolateMode.LINEAR
) -> Table:
    """Linearly interpolate missing (None) values along the timestamp order."""
    names = [v.name for v in values]
    packed = table.groupby().reduce(
        _pw_rows=reducers.sorted_tuple(
            ApplyExpression(
                lambda t, *vals: (t, vals), dt.ANY, args=(timestamp, *values)
            )
        )
    )

    def interp(rows):
        n = len(rows)
        out_rows = []
        cols = list(zip(*[vals for _, vals in rows])) if rows else []
        times = [t for t, _ in rows]
        filled = []
        for ci in range(len(cols)):
            col = list(cols[ci])
            for i in range(n):
                if col[i] is None:
                    # find neighbors
                    lo = next((j for j in range(i - 1, -1, -1) if col[j] is not None), None)
                    hi = next((j for j in range(i + 1, n) if col[j] is not None), None)
                    if lo is not None and hi is not None:
                        t0, t1 = times[lo], times[hi]
                        w = (times[i] - t0) / (t1 - t0) if t1 != t0 else 0.0
                        col[i] = col[lo] + (col[hi] - col[lo]) * w
                    elif lo is not None:
                        col[i] = col[lo]
                    elif hi is not None:
                        col[i] = col[hi]
            filled.append(col)
        for i in range(n):
            out_rows.append((times[i], tuple(c[i] for c in filled)))
        return out_rows

    exploded = packed.select(
        _pw_interp=ApplyExpression(interp, dt.ANY, args=(packed._pw_rows,))
    ).flatten(this._pw_interp)
    return exploded.select(
        timestamp=ApplyExpression(lambda r: r[0], dt.ANY, args=(this._pw_interp,)),
        **{
            name: ApplyExpression(
                lambda r, _i=i: r[1][_i], dt.ANY, args=(this._pw_interp,)
            )
            for i, name in enumerate(names)
        },
    )
