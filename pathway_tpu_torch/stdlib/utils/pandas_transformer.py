"""``pw.pandas_transformer`` of the port — wrap a pandas function as a Table
transform (counterpart of ``pathway_tpu/stdlib/utils/pandas_transformer.py``).

Reference: python/pathway/stdlib/utils/pandas_transformer.py:124.  Semantics
kept: each input Table is materialized as a pandas DataFrame (indexed by row
id) on every update, the user function runs on whole frames, and its output
DataFrame becomes a Table typed by ``output_schema``; ``output_universe``
(argument name or index) asserts the result keeps that input's index.  Like
the reference, this is deliberately *non-incremental* — each tick recomputes
from the full frames (the packed global reduce makes that explicit).
"""

from __future__ import annotations

import inspect
from typing import Optional, Union

from ...internals import dtype as dt
from ...internals.expression import ApplyExpression
from ...internals.keys import Pointer, ref_scalar
from ...internals.table import Table
from .col import unpack_col

__all__ = ["pandas_transformer"]


def _packed_frame(table: Table):
    """One-row Table with the whole input packed as a tuple-of-row-tuples.

    A ``tuple`` reducer (not a batched select) so the pack tracks the full
    accumulated table state across deltas, with retractions handled."""
    from ...internals import api_reducers

    names = table.column_names
    cols = [table[name] for name in names]
    tupled = table.select(
        _row=ApplyExpression(
            lambda *a: (Pointer(int(a[0])),) + tuple(a[1:]),
            dt.ANY,
            args=(table.id, *cols),
        )
    )
    return tupled.reduce(_all=api_reducers.tuple(tupled._row))


def _as_dataframe(rows, column_names):
    import pandas as pd

    rows = rows or ()
    # object dtype: a plain list of Pointers would coerce to Int64Index,
    # losing the "this is an engine key" marker
    index = pd.Index([r[0] for r in rows], dtype=object)
    data = {
        name: [r[i + 1] for r in rows] for i, name in enumerate(column_names)
    }
    df = pd.DataFrame(data, index=index)
    return df


def _argument_index(func, arg: Union[str, int, None]) -> Optional[int]:
    if arg is None:
        return None
    names = list(inspect.signature(func).parameters)
    if isinstance(arg, str):
        if arg not in names:
            raise ValueError(f"wrong output universe. No argument of name: {arg}")
        return names.index(arg)
    if arg < 0 or arg >= len(names):
        raise ValueError("wrong output universe. Index out of range")
    return arg


def pandas_transformer(
    output_schema, output_universe: Union[str, int, None] = None
):
    """Decorator: ``func(*frames: pd.DataFrame) -> pd.DataFrame`` becomes
    ``func(*tables: pw.Table) -> pw.Table``."""

    def decorator(func):
        universe_index = _argument_index(func, output_universe)

        def transformer(*inputs: Table) -> Table:
            import pandas as pd

            if not inputs:
                from ... import debug

                result = func()
                if isinstance(result, pd.Series):
                    result = pd.DataFrame(result)
                result.columns = output_schema.column_names()
                return debug.table_from_pandas(result).update_types(
                    **output_schema.typehints()
                )

            # one-row table holding every input's packed tuple (cross join of
            # the per-input global reduces)
            packed = [_packed_frame(t) for t in inputs]
            combined = packed[0].select(_0=packed[0]._all)
            for idx in range(1, len(packed)):
                combined = combined.join(packed[idx]).select(
                    **{f"_{i}": combined[f"_{i}"] for i in range(idx)},
                    **{f"_{idx}": packed[idx]._all},
                )

            input_names = [t.column_names for t in inputs]

            def run(*packed_rows):
                frames = [
                    _as_dataframe(rows, names)
                    for rows, names in zip(packed_rows, input_names)
                ]
                result = func(*frames)
                if isinstance(result, pd.Series):
                    result = pd.DataFrame(result)
                result.columns = output_schema.column_names()
                if universe_index is not None:
                    if not result.index.equals(frames[universe_index].index):
                        raise ValueError(
                            "resulting universe does not match the universe"
                            " of the indicated argument"
                        )
                else:
                    if not result.index.is_unique:
                        raise ValueError(
                            "index of resulting DataFrame must be unique"
                        )
                out = []
                for rid, row in zip(result.index, result.itertuples(index=False)):
                    # Pointer index values are engine keys carried over from an
                    # input frame (table.id); anything else is user data to hash
                    if not isinstance(rid, Pointer):
                        rid = ref_scalar(rid)
                    out.append((rid,) + tuple(row))
                return tuple(out)

            applied = combined.select(
                _rows=ApplyExpression(
                    run,
                    dt.ANY,
                    args=tuple(combined[f"_{i}"] for i in range(len(packed))),
                )
            )
            flat = applied.flatten(applied._rows)
            unpacked = unpack_col(
                flat._rows, "_id", *output_schema.column_names()
            )
            out = unpacked.with_id(unpacked._id).without("_id")
            return out.update_types(**output_schema.typehints())

        return transformer

    return decorator
