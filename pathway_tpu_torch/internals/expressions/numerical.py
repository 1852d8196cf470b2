"""``expr.num.*`` namespace (reference: python/pathway/internals/expressions/numerical.py)."""

from __future__ import annotations

import numpy as np

from .. import dtype as dt
from ..expression import ColumnExpression, MethodCallExpression


def _m(name, args, fun, return_type, vector_fun=None):
    return MethodCallExpression(name, args, fun, return_type, vector_fun=vector_fun)


class NumericalNamespace:
    def __init__(self, expr: ColumnExpression):
        self._e = expr

    def abs(self):
        return _m("num.abs", (self._e,), abs, dt.FLOAT, vector_fun=np.abs)

    def round(self, decimals=0):
        return _m(
            "num.round",
            (self._e,),
            lambda x: round(x, decimals),
            dt.FLOAT,
            vector_fun=lambda a: np.round(a, decimals),
        )

    def fill_na(self, default_value):
        def f(x):
            if x is None:
                return default_value
            if isinstance(x, float) and np.isnan(x):
                return default_value
            return x

        return _m("num.fill_na", (self._e,), f, dt.FLOAT)
