"""User-facing reducers: ``pw.reducers.*``
(reference: python/pathway/internals/reducers.py, src/engine/reduce.rs).

Each returns a ``ReducerExpression`` that the groupby lowering turns into an
engine ``ReducerSpec``.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from ..engine import reducers as engine_reducers
from .expression import (
    ColumnExpression,
    IdExpression,
    ReducerExpression,
    smart_coerce,
)

__all__ = [
    "count",
    "sum",
    "min",
    "max",
    "argmin",
    "argmax",
    "avg",
    "unique",
    "any",
    "sorted_tuple",
    "tuple",
    "ndarray",
    "earliest",
    "latest",
    "stateful_single",
    "stateful_many",
    "BaseCustomAccumulator",
    "udf_reducer",
]

_builtin_tuple = __builtins__["tuple"] if isinstance(__builtins__, dict) else tuple


def count(*args) -> ReducerExpression:
    return ReducerExpression(lambda: engine_reducers.CountReducer(), *args)


def sum(expr) -> ReducerExpression:
    return ReducerExpression(lambda: engine_reducers.SumReducer(), expr)


def min(expr) -> ReducerExpression:
    return ReducerExpression(lambda: engine_reducers.MinReducer(), expr)


def max(expr) -> ReducerExpression:
    return ReducerExpression(lambda: engine_reducers.MaxReducer(), expr)


def argmin(value_expr, arg_expr=None) -> ReducerExpression:
    if arg_expr is None:
        arg_expr = IdExpression(None)
    return ReducerExpression(lambda: engine_reducers.ArgMinReducer(), value_expr, arg_expr)


def argmax(value_expr, arg_expr=None) -> ReducerExpression:
    if arg_expr is None:
        arg_expr = IdExpression(None)
    return ReducerExpression(lambda: engine_reducers.ArgMaxReducer(), value_expr, arg_expr)


def avg(expr) -> ReducerExpression:
    return ReducerExpression(lambda: engine_reducers.AvgReducer(), expr)


def unique(expr) -> ReducerExpression:
    return ReducerExpression(lambda: engine_reducers.UniqueReducer(), expr)


def any(expr) -> ReducerExpression:
    return ReducerExpression(lambda: engine_reducers.AnyReducer(), expr)


def sorted_tuple(expr, *, skip_nones: bool = False) -> ReducerExpression:
    return ReducerExpression(
        lambda: engine_reducers.SortedTupleReducer(skip_nones=skip_nones), expr
    )


def tuple(expr, *, skip_nones: bool = False, instance=None) -> ReducerExpression:
    r = ReducerExpression(
        lambda: engine_reducers.TupleReducer(skip_nones=skip_nones), expr
    )
    r._needs_key_order = True
    return r


def ndarray(expr, *, skip_nones: bool = False) -> ReducerExpression:
    base = ReducerExpression(
        lambda: engine_reducers.TupleReducer(skip_nones=skip_nones), expr
    )
    base._needs_key_order = True
    base._post = lambda v: np.array(list(v)) if v is not None else None
    return base


def earliest(expr) -> ReducerExpression:
    return ReducerExpression(lambda: engine_reducers.EarliestReducer(), expr)


def latest(expr) -> ReducerExpression:
    return ReducerExpression(lambda: engine_reducers.LatestReducer(), expr)


def stateful_single(combine: Callable) -> Callable[..., ReducerExpression]:
    """``@stateful_single`` — combine(state, values) folded per group
    (reference: stateful reducers, src/engine/dataflow/operators/stateful_reduce.rs)."""

    def make(*exprs) -> ReducerExpression:
        def fold(state, rows):
            # rows are single values (one arg) or tuples (multiple args)
            return combine(state, [r if isinstance(r, _builtin_tuple) else (r,) for r in rows])

        return ReducerExpression(lambda: engine_reducers.StatefulReducer(fold), *exprs)

    return make


def stateful_many(combine: Callable) -> Callable[..., ReducerExpression]:
    return stateful_single(combine)


class BaseCustomAccumulator:
    """Base for user-defined accumulators used with ``pw.reducers.udf_reducer``
    (reference internals/custom_reducers.py:174).  Subclasses implement
    ``from_row`` / ``update`` / ``compute_result``; ``neutral`` and
    ``retract`` are optional accelerators — this engine re-folds surviving
    rows on retraction, so omitting ``retract`` stays correct."""

    @classmethod
    def neutral(cls):
        raise NotImplementedError

    @classmethod
    def from_row(cls, row):
        raise NotImplementedError

    def update(self, other) -> None:
        raise NotImplementedError

    def retract(self, other) -> None:
        raise NotImplementedError

    def compute_result(self):
        raise NotImplementedError

    def serialize(self):
        import pickle

        return pickle.dumps(self)

    @classmethod
    def deserialize(cls, val):
        import pickle

        return pickle.loads(val)


def udf_reducer(reducer_cls: type) -> Callable[..., ReducerExpression]:
    """Stateful reducer from a :class:`BaseCustomAccumulator` subclass
    (reference internals/custom_reducers.py:280 ``udf_reducer``)."""

    def make(*exprs) -> ReducerExpression:
        def fold(state, rows):
            # rows is never empty: StatefulReducer drops groups whose rows
            # all retracted before calling the fold (neutral()/retract() are
            # reference-side optimizations; re-folding survivors is already
            # retraction-correct here)
            acc = None
            for r in rows:
                row = list(r) if isinstance(r, _builtin_tuple) else [r]
                nxt = reducer_cls.from_row(row)
                if acc is None:
                    acc = nxt
                else:
                    acc.update(nxt)
            return acc.compute_result() if acc is not None else None

        return ReducerExpression(lambda: engine_reducers.StatefulReducer(fold), *exprs)

    return make
